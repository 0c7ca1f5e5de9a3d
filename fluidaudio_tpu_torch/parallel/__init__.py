"""See the package docstring of `fluidaudio_tpu_torch`."""

from fluidaudio_tpu_torch.parallel.mesh import (
    make_mesh,
    param_sharding_rules,
    shard_batch,
    shard_params,
)

__all__ = ["make_mesh", "shard_batch", "shard_params", "param_sharding_rules"]
