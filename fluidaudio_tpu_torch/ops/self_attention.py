"""Multi-head self-attention core in f32: CUDA kernel + plain version.

The Sortformer head's attention (`models/sortformer.py::_NemoTfBlock`):
q, k, v are [B, N, H, Dh], as the reshaped outputs of its nn.Linear layers
lie, and `valid` is an optional [B, N] bool. A valid query takes the softmax
of q . k / sqrt(Dh) over the valid keys; a masked query takes the mean of v
over all N positions (the uniform row that f32-min scores give), never NaN;
`valid=None` means every position is valid. The result is [B, N, H, Dh], so
`reshape(B, N, H * Dh)` feeds the output projection.

On a CUDA tensor `self_attention` launches the hand-written kernel
(`csrc/self_attention.cu`, f32 only, built with nvcc at first use into
`_build/` by `ops/build.py`) or raises; on a CPU tensor it runs
`self_attention_plain`. There is no fallback from one to the other. The
inputs may be strided views: any [B, N, H, Dh] whose last axis is
contiguous and whose other strides are multiples of 16 bytes. The kernel
writes a new contiguous f32 tensor.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from fluidaudio_tpu_torch.ops import build
from fluidaudio_tpu_torch.ops.attention import _strides

KERNEL_SOURCE = build.CSRC / "self_attention.cu"


def kernel_takes_head_dim(head_dim: int) -> bool:
    """Whether the kernel takes this head width (8, 16, ..., 64): callers
    branch on it before a launch."""
    return head_dim % 8 == 0 and 8 <= head_dim <= 64


def self_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version with the kernel's semantics, in q's dtype with f32
    scores and softmax (JAX's division by a NumPy scalar promotes them).
    Runs on the tensors' own device and counts its calls in `.calls`."""
    self_attention_plain.calls += 1
    Dh = q.shape[-1]
    scores = torch.einsum("bnhd,bmhd->bhnm", q, k).float() / np.float32(math.sqrt(Dh))
    if valid is not None:
        mask = valid[:, None, None, :] & valid[:, None, :, None]
        scores = torch.where(mask, scores, torch.finfo(q.dtype).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v)


self_attention_plain.calls = 0  # calls since the last reset, on any device


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel's shared library."""
    lib = build.load_library(KERNEL_SOURCE)
    fn = lib.self_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.self_attention_smem_bytes.argtypes = [ctypes.c_int]
    lib.self_attention_smem_bytes.restype = ctypes.c_int
    return lib


def _check(q, k, v, valid) -> None:
    if q.ndim != 4:
        raise ValueError(f"q must be [B, N, H, Dh], got {tuple(q.shape)}")
    B, N = q.shape[:2]
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != q shape {tuple(q.shape)}")
    if valid is not None:
        if tuple(valid.shape) != (B, N):
            raise ValueError(f"valid shape {tuple(valid.shape)} != {(B, N)}")
        if valid.dtype != torch.bool:
            raise ValueError(f"valid must be bool, got {valid.dtype}")
    for name, x in (("k", k), ("v", v), ("valid", valid)):
        if x is not None and x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """-> [B, N, H, Dh]. CUDA tensors launch the kernel (f32, contiguous
    result); CPU tensors run the plain version."""
    _check(q, k, v, valid)
    if q.device.type == "cpu":
        return self_attention_plain(q, k, v, valid)
    B, N, H, Dh = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.float32:
            raise ValueError(f"kernel takes float32, got {name} {x.dtype}")
    if not kernel_takes_head_dim(Dh):
        raise ValueError(f"kernel takes Dh in 8, 16, ..., 64, got {Dh}")
    strides = []
    for name, x in (("q", q), ("k", k), ("v", v)):
        strides += _strides(name, x)
    if q.device.type != "cuda":
        raise ValueError(f"self_attention runs on cuda or cpu, not {q.device}")
    vb, vn = valid.stride() if valid is not None else (0, 0)
    out = torch.empty((B, N, H, Dh), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = load_library().self_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            valid.data_ptr() if valid is not None else None, out.data_ptr(),
            (ctypes.c_longlong * 9)(*strides), vb, vn, B, N, H, Dh, stream)
    if err != 0:
        raise RuntimeError(f"self_attention kernel launch failed: CUDA error {err}")
    self_attention.launches += 1
    return out


self_attention.launches = 0  # kernel launches since the last reset
