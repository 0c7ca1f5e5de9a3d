"""Device mesh and sharding rules on torch.distributed.

Port of `fluidaudio_tpu/parallel/mesh.py`. A 2-D ("data", "model")
`DeviceMesh` over the ranks of the process group, one device per rank:

- "data": the batch of audio windows / files / streams (the reference's
  worker pool and multi-stream parallelism become this axis)
- "model": the rule that shards parameters over hidden dims

Every rank runs the same program on the same request (SPMD, as JAX's one
program over the mesh): `shard_batch` gives each rank its rows of the
global batch, `shard_params` each its part of every parameter, as
`DTensor`s. The collectives are explicit in `parallel/train.py`,
`parallel/infer.py` and the managers' `set_mesh` paths.

The tests run a gloo group of spawned CPU processes, one per "device", as
JAX's tests run 8 virtual CPU devices; a user launches one process per card
with `torchrun` (NCCL). With no process group and one device, `make_mesh`
brings up a single-process group itself.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from fluidaudio_tpu_torch.utils.device import resolve_device
from fluidaudio_tpu_torch.utils.weights import to_jax_key_and_shape

AXES = ("data", "model")


def make_mesh(n_devices: int | None = None, data: int | None = None, model: int = 1, *,
              device: torch.device | str | None = None) -> DeviceMesh:
    """Build a ("data", "model") mesh over the process group's ranks.

    `device=None` is the card (NCCL); `"cpu"` runs over gloo. Without a
    process group, `n_devices` of None or 1 brings up a one-rank group in
    this process; more ranks need a launcher (`torchrun`) or a caller that
    initialises the group. `n_devices` defaults to the group's size and
    must equal it. With several ranks on cards and no card index given,
    each rank takes card `LOCAL_RANK` (torchrun's), else its rank modulo the
    cards it sees: the `DeviceMesh` would pick it only while CUDA is
    uninitialised, which `resolve_device` is not. Call it before building
    the models that `device=None` puts on that card."""
    on_card = device is None or torch.device(device).type == "cuda"
    index_given = device is not None and torch.device(device).index is not None
    if (on_card and not index_given and torch.cuda.is_available()
            and dist.is_initialized() and dist.get_world_size() > 1):
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count())))
    device = resolve_device(device)
    if not dist.is_initialized():
        if (n_devices or 1) != 1:
            raise RuntimeError(
                f"make_mesh({n_devices}) needs a process group of {n_devices} ranks: "
                "launch one process per device (torchrun) or init_process_group first")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    n = n_devices or world
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if n != world:
        raise ValueError(f"mesh of {n} devices over a process group of {world} ranks")
    return init_device_mesh(device.type, (data, model), mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The mesh's extent along "data" or "model" (JAX's `mesh.shape[axis]`)."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_rows(mesh: DeviceMesh, n_rows: int) -> slice:
    """This rank's rows of a batch of `n_rows` split over "data" (a
    multiple of the axis, as JAX's sharded batch must be)."""
    n_data = axis_size(mesh, "data")
    if n_rows % n_data:
        raise ValueError(f"batch of {n_rows} rows is not a multiple of the mesh data axis "
                         f"({n_data})")
    per = n_rows // n_data
    r = mesh.get_local_rank("data")
    return slice(r * per, (r + 1) * per)


def gather_rows(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """All-gather this rank's rows over "data" back into the whole batch,
    in rank order (the inverse of `local_rows`)."""
    group = mesh.get_group("data")
    if group.size() == 1:
        return x
    sent = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()  # gloo has no bool
    parts = [torch.empty_like(sent) for _ in range(group.size())]
    dist.all_gather(parts, sent, group=group)
    return torch.cat(parts).to(x.dtype)


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: DeviceMesh, tree: Any) -> Any:
    """Place arrays with their leading axis sharded over "data": each leaf
    (numpy or tensor, the same global batch on every rank) becomes a
    `DTensor` whose local part is this rank's rows, on its device."""
    device = mesh_device(mesh)

    def put(x):
        x = torch.as_tensor(x).to(device)
        if x.ndim == 0:
            return DTensor.from_local(x, mesh, [Replicate(), Replicate()], run_check=False)
        return DTensor.from_local(x[local_rows(mesh, x.shape[0])].contiguous(), mesh,
                                  [Shard(0), Replicate()], run_check=False,
                                  shape=x.shape, stride=x.contiguous().stride())

    return _tree_map(put, tree)


def _named_tensors(params) -> dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_sharding_rules(mesh: DeviceMesh, params) -> dict[str, tuple]:
    """Tensor-parallel placements for a parameter set (an `nn.Module`, or a
    mapping of dotted torch names to tensors): name -> (data placement,
    model placement).

    JAX's heuristic rule (`fluidaudio_tpu/parallel/mesh.py`), applied to
    each parameter's flax name and layout (`utils.weights.
    to_jax_key_and_shape`): a kernel or embedding of rank >= 2 shards its
    last flax axis over "model" when divisible, a 1-D bias shards, the rest
    is replicated. The sharded flax axis is then mapped to its torch axis:
    axis 0 of a Linear or conv weight, axis 1 of an `[V, D]` embedding.
    Torch's own names are not matched ("weight" would catch the LayerNorm
    scales). Every parameter is replicated over "data"."""
    model_size = axis_size(mesh, "model")
    rules = {}
    for name, x in _named_tensors(params).items():
        flax_name, shape, axes = to_jax_key_and_shape(name, tuple(x.shape))
        rules[name] = (Replicate(), Replicate())
        if model_size == 1 or not shape:
            continue
        key = flax_name.lower()
        if (len(shape) >= 2 and shape[-1] % model_size == 0
                and ("kernel" in key or "embedding" in key)):
            rules[name] = (Replicate(), Shard(axes[-1]))
        elif len(shape) == 1 and shape[0] % model_size == 0 and "bias" in key:
            rules[name] = (Replicate(), Shard(0))
    return rules


def shard_params(mesh: DeviceMesh, params) -> dict[str, torch.Tensor]:
    """name -> `DTensor` placed by `param_sharding_rules`, on this rank's
    device; a parameter that required grad still does."""
    rules = param_sharding_rules(mesh, params)
    device = mesh_device(mesh)
    out = {}
    for name, x in _named_tensors(params).items():
        d = distribute_tensor(x.detach().to(device), mesh, list(rules[name]))
        out[name] = d.requires_grad_(x.requires_grad)
    return out


def full(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a `DTensor` (gathered over "model",
    differentiable), or `x` itself."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def local(x: torch.Tensor) -> torch.Tensor:
    """This rank's part of a `DTensor`, or `x` itself."""
    return x.to_local() if isinstance(x, DTensor) else x
