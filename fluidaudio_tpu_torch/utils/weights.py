"""Load the JAX package's npz parameter trees into torch modules.

The npz files hold a flax parameter tree flattened to '/'-joined keys
(`fluidaudio_tpu/utils/checkpoint.py`), e.g.
`params/block0/mhsa/q/kernel`. This module reads those keys itself (no JAX)
and maps each to a torch `state_dict` key and layout:

- flax Dense `kernel [in, out]`            -> `weight [out, in]`
- flax Conv1d `kernel [k, in/g, out]`       -> `weight [out, in/g, k]` (the
  depthwise FSMN `[K, 1, D]` -> `[D, 1, K]`, Silero's STFT basis
  `[256, 1, 258]` -> `[258, 1, 256]`, the segmentation stem
  `[251, 1, C]` -> `[C, 1, 251]`)
- flax DenseGeneral in attention (`nn.SelfAttention` /
  `MultiHeadDotProductAttention`): `query`/`key`/`value` `kernel [d, H, Dh]`
  -> `weight [H*Dh, d]` and `bias [H, Dh]` -> `[H*Dh]`; `out`
  `kernel [H, Dh, d]` -> `weight [d, H*Dh]`. A 3-D kernel under those names
  is never a Conv1d (the two have the same rank, so the name decides).
- flax Conv2d `kernel [kh, kw, in/g, out]`  -> `weight [out, in/g, kh, kw]`
  (StyleTTS2's style encoders: 3x3, 5x5 and 1x1)
- the transposed-conv kernels that Kokoro (and StyleTTS2) keep as free
  params, `[k, in/g, out]` (the JAX package applies them as an
  input-dilated convolution with the kernel flipped in time), by name into
  `F.conv_transpose1d`'s `[in, out/g, k]`, unflipped: `pool_kernel`
  (depthwise, groups = out: `[3, 1, C]` -> `[C, 1, 3]`) and `up_kernel_<i>`
  (groups 1: `[k, in, out]` -> `[in, out, k]`). The generic 3-D rule would
  give `[out, in/g, k]`, which fits the shape wherever in == out.
- Mimi's streaming transposed convs (`StreamConvTr`) keep the same
  `[k, in/g, out]` under the leaf `kernel` of their module, so they are
  mapped by the owner's name into `F.conv_transpose1d`'s layout as a
  `weight`: `upsample` (depthwise, groups = out) and `up_<i>` (groups 1).
  The generic 3-D rule would read them as a Conv1d.
- the Snake `alpha1_<i>` / `alpha2_<i>` (Kokoro, StyleTTS2) and `alpha<i>`
  (Supertonic-3's vocoder) `[1, 1, C]` (for [B, T, C] activations) ->
  `[1, C, 1]` (the port's channels-first [B, C, T]).
- flax LayerNorm `scale`                    -> `weight`
- JAX `Int8Dense` `kernel_q [in, out]` int8 -> `weight_q [out, in]` int8
  (K contiguous, the layout the int8 kernel reads), `kernel_scale [1, out]`
  f32 -> `weight_scale [out]`
- everything else (`bias`, `bn_scale`/`bn_bias`, `pos_bias_u`/`pos_bias_v`,
  `embedding`, the free tables: Nemotron's `prompt_embed`, SenseVoice's
  `embed`, Cohere's `pos_embed`) keeps its name and layout. Cohere's output
  head is its `embed.embedding`, tied, so it has no key of its own.

The leading `params` collection is dropped and '/' becomes '.', so
`params/block0/mhsa/q/kernel` lands on `block0.mhsa.q.weight`.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


_DENSE_GENERAL_IN = ("query", "key", "value")
_UP_KERNEL = re.compile(r"up_kernel_\d+")
_SNAKE_ALPHA = re.compile(r"alpha[12]_\d+|alpha\d+")
_STREAM_CONVTR = re.compile(r"upsample|up_\d+")


def conv_transpose_weight(kernel: np.ndarray, groups: int) -> np.ndarray:
    """A JAX transposed-conv kernel `[k, in/g, out]` -> `F.conv_transpose1d`'s
    `[in, out/g, k]`: w[g*(in/g) + i, o, t] = kernel[t, i, g*(out/g) + o]."""
    k, ipg, out = kernel.shape
    w = kernel.reshape(k, ipg, groups, out // groups).transpose(2, 1, 3, 0)
    return w.reshape(groups * ipg, out // groups, k)


def _torch_key_and_value(flax_key: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    parts = flax_key.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    leaf = parts[-1]
    owner = parts[-2] if len(parts) > 1 else ""
    if owner in _DENSE_GENERAL_IN and leaf == "kernel" and value.ndim == 3:
        value = value.reshape(value.shape[0], -1).T
        parts[-1] = "weight"
    elif owner in _DENSE_GENERAL_IN and leaf == "bias" and value.ndim == 2:
        value = value.reshape(-1)
    elif owner == "out" and leaf == "kernel" and value.ndim == 3:
        value = value.reshape(-1, value.shape[-1]).T
        parts[-1] = "weight"
    elif leaf == "pool_kernel" and value.ndim == 3:
        value = conv_transpose_weight(value, groups=value.shape[2])
    elif _UP_KERNEL.fullmatch(leaf) and value.ndim == 3:
        value = conv_transpose_weight(value, groups=1)
    elif _STREAM_CONVTR.fullmatch(owner) and leaf == "kernel" and value.ndim == 3:
        value = conv_transpose_weight(value, groups=value.shape[2] if owner == "upsample" else 1)
        parts[-1] = "weight"
    elif _SNAKE_ALPHA.fullmatch(leaf) and value.ndim == 3:
        value = value.reshape(1, -1, 1)
    elif leaf == "kernel":
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
