"""Load the JAX package's npz parameter trees into torch modules.

The npz files hold a flax parameter tree flattened to '/'-joined keys
(`fluidaudio_tpu/utils/checkpoint.py`), e.g.
`params/block0/mhsa/q/kernel`. This module reads those keys itself (no JAX)
and maps each to a torch `state_dict` key and layout:

- flax Dense `kernel [in, out]`            -> `weight [out, in]`
- flax Conv1d `kernel [k, in/g, out]`       -> `weight [out, in/g, k]`
- flax Conv2d `kernel [kh, kw, in/g, out]`  -> `weight [out, in/g, kh, kw]`
- flax LayerNorm `scale`                    -> `weight`
- JAX `Int8Dense` `kernel_q [in, out]` int8 -> `weight_q [out, in]` int8
  (K contiguous, the layout the int8 kernel reads), `kernel_scale [1, out]`
  f32 -> `weight_scale [out]`
- everything else (`bias`, `bn_scale`/`bn_bias`, `pos_bias_u`/`pos_bias_v`,
  `embedding`, the Nemotron `prompt_embed` table) keeps its name and layout.

The leading `params` collection is dropped and '/' becomes '.', so
`params/block0/mhsa/q/kernel` lands on `block0.mhsa.q.weight`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _torch_key_and_value(flax_key: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    parts = flax_key.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    leaf = parts[-1]
    if leaf == "kernel":
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 3:
            value = value.transpose(2, 1, 0)
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"unsupported kernel rank {value.ndim} at {flax_key}")
        parts[-1] = "weight"
    elif leaf == "kernel_q":
        value = value.T
        parts[-1] = "weight_q"
    elif leaf == "kernel_scale":
        value = value.reshape(-1)
        parts[-1] = "weight_scale"
    elif leaf == "scale":
        parts[-1] = "weight"
    return ".".join(parts), np.array(value, order="C")  # a writable copy


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict of arrays -> {'/'-joined key: numpy array}."""
    flat: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def from_jax_params(params_numpy: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """A flax parameter tree (nested dict or flat '/'-keyed dict of numpy
    arrays) -> torch-layout state {dotted key: numpy array}."""
    flat = flatten_tree(params_numpy)
    state: dict[str, np.ndarray] = {}
    for k, v in flat.items():
        tk, tv = _torch_key_and_value(k, v)
        state[tk] = tv
    return state


def load_npz(path: str | Path) -> dict[str, np.ndarray]:
    """One npz checkpoint -> torch-layout state."""
    with np.load(path) as data:
        return from_jax_params({k: data[k] for k in data.files})


def load_state(module: nn.Module, state: Mapping[str, np.ndarray | torch.Tensor]) -> None:
    """Copy `state` (numpy arrays or tensors) into `module` in place, casting
    to each entry's dtype and device. Raises ValueError on a missing, extra or
    mis-shaped key."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(
            f"checkpoint mismatch: missing={missing[:5]} extra={extra[:5]}"
        )
    for key, target in own.items():
        value = state[key]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"shape mismatch at {key}: {tuple(value.shape)} vs {tuple(target.shape)}"
            )
    with torch.no_grad():
        for key, target in own.items():
            target.copy_(torch.as_tensor(state[key]))
