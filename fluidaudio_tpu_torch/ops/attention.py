"""Transformer-XL relative-position attention: CUDA kernel + plain version.

Port of `fluidaudio_tpu/ops/attention_pallas.py`. `relpos_attention` keeps the
JAX signature and layout: qu = q + pos_bias_u, qw = q + pos_bias_v, k, v in
[B, H, T, Dh], the position projections p in [H, 2T-1, Dh] (XL row order:
offset T-1 down to -(T-1)), valid key counts `lengths` [B] int32, and it
returns f32 [B, H, T, Dh]. Padded query rows (t >= length) hold values the
caller masks downstream; compare valid rows only.

On a CUDA tensor the wrapper launches the hand-written kernel
(`csrc/relpos_attention.cu`, built with nvcc at first use into `_build/`)
or raises; on a CPU tensor it runs `relpos_attention_plain`, the torch port
of `relpos_attention_reference`. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
KERNEL_SOURCE = _PKG / "csrc" / "relpos_attention.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def relpos_attention_plain(qu, qw, k, v, p, lengths, t_real: int) -> torch.Tensor:
    """Plain torch version with the kernel's semantics, computed in f32."""
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
    return torch.einsum("bhts,bhsd->bhtd", probs, v.to(f32))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel's shared library."""
    src = KERNEL_SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"librelpos_attention_{tag}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.relpos_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def build_seconds() -> float:
    """Build and load the library; seconds it took (0 if already loaded)."""
    if load_library.cache_info().currsize:
        return 0.0
    t0 = time.perf_counter()
    load_library()
    return time.perf_counter() - t0


def _check(qu, qw, k, v, p, lengths, t_real: int) -> None:
    if qu.ndim != 4:
        raise ValueError(f"qu must be [B, H, T, Dh], got {tuple(qu.shape)}")
    B, H, T, Dh = qu.shape
    if T != t_real:
        raise ValueError(f"T axis {T} != t_real {t_real}")
    for name, x in (("qw", qw), ("k", k), ("v", v)):
        if tuple(x.shape) != (B, H, T, Dh):
            raise ValueError(f"{name} shape {tuple(x.shape)} != {(B, H, T, Dh)}")
    if tuple(p.shape) != (H, 2 * T - 1, Dh):
        raise ValueError(f"p shape {tuple(p.shape)} != {(H, 2 * T - 1, Dh)}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != {(B,)}")
    for name, x in (("qu", qu), ("qw", qw), ("k", k), ("v", v), ("p", p),
                    ("lengths", lengths)):
        if x.device != qu.device:
            raise ValueError(f"{name} is on {x.device}, qu on {qu.device}")


def relpos_attention(qu, qw, k, v, p, lengths, t_real: int) -> torch.Tensor:
    """-> [B, H, T, Dh] f32. CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    _check(qu, qw, k, v, p, lengths, t_real)
    if qu.device.type == "cpu":
        return relpos_attention_plain(qu, qw, k, v, p, lengths, t_real)
    if qu.device.type != "cuda":
        raise ValueError(f"relpos_attention runs on cuda or cpu, not {qu.device}")
    B, H, T, Dh = qu.shape
    if qu.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel takes bfloat16 or float32, got {qu.dtype}")
    for name, x in (("qu", qu), ("qw", qw), ("k", k), ("v", v), ("p", p)):
        if x.dtype != qu.dtype:
            raise ValueError(f"{name} dtype {x.dtype} != qu dtype {qu.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous int32 tensor")
    if Dh % 16 or not 16 <= Dh <= 128:
        raise ValueError(f"kernel takes Dh in 16, 32, ..., 128, got {Dh}")
    for name, x in (("qu", qu), ("qw", qw), ("k", k), ("v", v), ("p", p)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (vector loads)")
    out = torch.empty((B, H, T, Dh), dtype=torch.float32, device=qu.device)
    with torch.cuda.device(qu.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = load_library().relpos_attention_launch(
            qu.data_ptr(), qw.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, H, T, Dh,
            int(qu.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"relpos_attention kernel launch failed: CUDA error {err}")
    relpos_attention.launches += 1
    return out


relpos_attention.launches = 0  # kernel launches since the last reset
