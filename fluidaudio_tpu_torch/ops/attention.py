"""Transformer-XL relative-position attention: CUDA kernel + plain version.

Port of `fluidaudio_tpu/ops/attention_pallas.py`. `relpos_attention` keeps the
JAX signature and layout: qu = q + pos_bias_u, qw = q + pos_bias_v, k, v in
[B, H, T, Dh], the position projections p in [H, 2T-1, Dh] (XL row order:
offset T-1 down to -(T-1)), valid key counts `lengths` [B] int32, and it
returns f32 [B, H, T, Dh]. Padded query rows (t >= length) hold values the
caller masks downstream; compare valid rows only.

The inputs may be strided views: any [B, H, T, Dh] (and [H, 2T-1, Dh] for p)
whose last axis is contiguous and whose other strides are multiples of 16
bytes, such as `x.transpose(1, 2)` of a [B, T, H, Dh] projection, so the
encoder passes its projections as they lie. `out=` takes a [B, H, T, Dh]
view in bf16 or f32 under the same rule; the result is written there (bf16
rounded once, to nearest even) and `out` is returned.

On a CUDA tensor the wrapper launches the hand-written kernel
(`csrc/relpos_attention.cu`, built with nvcc at first use into `_build/` by
`ops/build.py`) or raises; on a CPU tensor it runs `relpos_attention_plain`,
the torch port of `relpos_attention_reference`. There is no fallback from
one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from fluidaudio_tpu_torch.ops import build

KERNEL_SOURCE = build.CSRC / "relpos_attention.cu"


def kernel_takes_head_dim(head_dim: int) -> bool:
    """Whether the kernel takes this head width (16, 32, ..., 128): callers
    branch on it before a launch, as the JAX encoder branches on Dh."""
    return head_dim % 16 == 0 and 16 <= head_dim <= 128


def relpos_attention_plain(qu, qw, k, v, p, lengths, t_real: int, *,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version with the kernel's semantics, computed in f32;
    with `out=` the result is copied there (`out.copy_`) and `out` returned.
    Runs on the tensors' own device and counts its calls in `.calls`."""
    relpos_attention_plain.calls += 1
    B, H, T, Dh = qu.shape
    f32 = torch.float32
    ac = torch.einsum("bhtd,bhsd->bhts", qu.to(f32), k.to(f32))
    # XL shift as an explicit gather: bd[t, s] = raw[t, (t_real-1) + (s - t)]
    ar = torch.arange(T, device=qu.device)
    r = ar[None, :] - ar[:, None] + (t_real - 1)
    pr = torch.einsum("bhtd,hrd->bhtr", qw.to(f32), p.to(f32))
    bd = torch.take_along_dim(pr, r.expand(B, H, T, T), dim=-1)
    scores = (ac + bd) / math.sqrt(Dh)
    limit = torch.clamp(lengths.to(torch.int64), max=t_real)
    valid = ar[None, None, None, :] < limit[:, None, None, None]
    scores = torch.where(valid, scores, torch.finfo(f32).min)
    probs = torch.softmax(scores, dim=-1)
    result = torch.einsum("bhts,bhsd->bhtd", probs, v.to(f32))
    if out is None:
        return result
    return out.copy_(result)


relpos_attention_plain.calls = 0  # calls since the last reset, on any device


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel's shared library."""
    lib = build.load_library(KERNEL_SOURCE)
    fn = lib.relpos_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.relpos_attention_smem_bytes.argtypes = [ctypes.c_int]
    lib.relpos_attention_smem_bytes.restype = ctypes.c_int
    return lib


def _check(qu, qw, k, v, p, lengths, t_real: int, out) -> None:
    if qu.ndim != 4:
        raise ValueError(f"qu must be [B, H, T, Dh], got {tuple(qu.shape)}")
    B, H, T, Dh = qu.shape
    if T != t_real:
        raise ValueError(f"T axis {T} != t_real {t_real}")
    same_shape = [("qw", qw), ("k", k), ("v", v)] + ([("out", out)] if out is not None else [])
    for name, x in same_shape:
        if tuple(x.shape) != (B, H, T, Dh):
            raise ValueError(f"{name} shape {tuple(x.shape)} != {(B, H, T, Dh)}")
    if tuple(p.shape) != (H, 2 * T - 1, Dh):
        raise ValueError(f"p shape {tuple(p.shape)} != {(H, 2 * T - 1, Dh)}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != {(B,)}")
    for name, x in (("qw", qw), ("k", k), ("v", v), ("p", p), ("lengths", lengths), ("out", out)):
        if x is not None and x.device != qu.device:
            raise ValueError(f"{name} is on {x.device}, qu on {qu.device}")


def _strides(name: str, x: torch.Tensor) -> list[int]:
    """The element strides of every axis but the last, which must be
    contiguous; each a multiple of 16 bytes, as the start must be. An axis
    of size 1 is never stepped along, so its stride is taken as the one a
    contiguous tensor would have."""
    if x.stride(-1) != 1:
        raise ValueError(f"{name} must have a contiguous last axis, got strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (TMA and vector access)")
    per16 = 16 // x.element_size()  # elements in 16 bytes
    out, span = [], x.shape[-1]  # elements the inner axes span
    for size, stride in reversed(list(zip(x.shape[:-1], x.stride()[:-1]))):
        if size == 1:
            stride = -(-span // per16) * per16
        if stride <= 0 or stride % per16:
            raise ValueError(f"{name} strides {x.stride()} must be positive multiples of 16 bytes")
        out.append(stride)
        span = max(span, stride * size)
    return out[::-1]


def relpos_attention(qu, qw, k, v, p, lengths, t_real: int, *,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """-> [B, H, T, Dh]: f32, or `out` filled. CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    _check(qu, qw, k, v, p, lengths, t_real, out)
    if qu.device.type == "cpu":
        return relpos_attention_plain(qu, qw, k, v, p, lengths, t_real, out=out)
    if qu.device.type != "cuda":
        raise ValueError(f"relpos_attention runs on cuda or cpu, not {qu.device}")
    B, H, T, Dh = qu.shape
    if qu.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel takes bfloat16 or float32, got {qu.dtype}")
    for name, x in (("qw", qw), ("k", k), ("v", v), ("p", p)):
        if x.dtype != qu.dtype:
            raise ValueError(f"{name} dtype {x.dtype} != qu dtype {qu.dtype}")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous int32 tensor")
    if not kernel_takes_head_dim(Dh):
        raise ValueError(f"kernel takes Dh in 16, 32, ..., 128, got {Dh}")
    if out is None:
        out = torch.empty((B, H, T, Dh), dtype=torch.float32, device=qu.device)
    elif out.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out must be bfloat16 or float32, got {out.dtype}")
    strides = []
    for name, x in (("qu", qu), ("qw", qw), ("k", k), ("v", v), ("out", out), ("p", p)):
        strides += _strides(name, x)
    with torch.cuda.device(qu.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = load_library().relpos_attention_launch(
            qu.data_ptr(), qw.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), (ctypes.c_longlong * 17)(*strides),
            B, H, T, Dh, int(qu.dtype == torch.bfloat16), int(out.dtype == torch.bfloat16),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"relpos_attention kernel launch failed: CUDA error {err}")
    relpos_attention.launches += 1
    return out


relpos_attention.launches = 0  # kernel launches since the last reset
