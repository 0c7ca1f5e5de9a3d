"""Dynamic-quantising int8 matmul: CUDA kernel + plain version.

Port of `fluidaudio_tpu/ops/quant_pallas.py::int8_matmul_fused`, the same
function as `ops/quant.py::Int8Dense`: x [M, K] (bf16 or f32) is quantised
per row to int8 with a dynamic symmetric scale, multiplied by the
pre-quantised weight codes into int32, and dequantised as
`((acc * s_row) * s_col) + bias` in f32 before the cast to `out_dtype`.

Layout: the weight codes are `wq [N, K]` int8 (the torch Linear layout, K
contiguous), the column scales `ws [N]` f32 and `bias [N]` f32 or None;
the JAX package's `[K, N]` / `[1, N]` become these in `utils/weights.py`.

On a CUDA tensor the wrapper launches the hand-written kernel
(`csrc/int8_matmul_fused.cu`, built with nvcc at first use by
`ops/build.py`) or raises; on a CPU tensor it runs
`int8_matmul_fused_plain`. There is no fallback from one to the other. The
two agree bit for bit: the kernel rounds where the plain version does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fluidaudio_tpu_torch.ops import build

KERNEL_SOURCE = build.CSRC / "int8_matmul_fused.cu"
INT32_MAX = 2**31 - 1
# |sum_k xq * wq| <= K * 127^2 must fit the kernel's int32 accumulators
MAX_K = INT32_MAX // 127**2 // 16 * 16


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[M, K] f32/bf16 -> (int8 [M, K], f32 scales [M, 1]), symmetric per row.

    Both divisions are by tensors: PyTorch's CUDA `tensor / python_scalar`
    multiplies by the reciprocal, which is not the IEEE quotient."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.maximum(amax, torch.full_like(amax, 1e-8)) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_matmul_fused_plain(x, wq, ws, bias=None, out_dtype=None) -> torch.Tensor:
    """Plain torch version with the kernel's rounding, on any device. The
    integer product accumulates in float64, exact below 2^53 (|acc| is at
    most K * 127^2), since CUDA has no integer matmul in torch."""
    xq, sx = quantize_rows(x)
    acc = xq.double() @ wq.double().T
    out = acc.float() * sx * ws.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype or x.dtype)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel's shared library."""
    lib = build.load_library(KERNEL_SOURCE)
    fn = lib.int8_matmul_fused_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.int8_gemm_dequant_smem_bytes.argtypes = []
    lib.int8_gemm_dequant_smem_bytes.restype = ctypes.c_int
    return lib


def _check(x, wq, ws, bias) -> None:
    if x.ndim != 2 or wq.ndim != 2:
        raise ValueError(f"x must be [M, K] and wq [N, K], got {tuple(x.shape)}, "
                         f"{tuple(wq.shape)}")
    (M, K), N = x.shape, wq.shape[0]
    if wq.shape[1] != K:
        raise ValueError(f"wq shape {tuple(wq.shape)} does not match K = {K}")
    if tuple(ws.shape) != (N,):
        raise ValueError(f"ws shape {tuple(ws.shape)} != {(N,)}")
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"bias shape {tuple(bias.shape)} != {(N,)}")
    if wq.dtype != torch.int8:
        raise ValueError(f"wq must be int8, got {wq.dtype}")
    for name, t in (("wq", wq), ("ws", ws), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def int8_matmul_fused(x, wq, ws, bias=None, out_dtype=None) -> torch.Tensor:
    """x [M, K] @ dequant(wq [N, K]).T -> [M, N] in `out_dtype` (default
    x's dtype). CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    _check(x, wq, ws, bias)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_matmul_fused_plain(x, wq, ws, bias, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul_fused runs on cuda or cpu, not {x.device}")
    (M, K), N = x.shape, wq.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel takes bfloat16 or float32 x, got {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel writes bfloat16 or float32, not {out_dtype}")
    for name, t in (("ws", ws), ("bias", bias)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("x", x), ("wq", wq), ("ws", ws), ("bias", bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if M == 0 or K % 16:
        raise ValueError(f"kernel takes M >= 1 and K a multiple of 16, got M={M} K={K}")
    if K > MAX_K or max(M, N) > INT32_MAX:
        raise ValueError(f"kernel takes K <= {MAX_K} (an int32 sum that cannot overflow) and "
                         f"M, N < 2^31 (int32 indices and TMA coordinates), got M={M} N={N} "
                         f"K={K}")
    for name, t in (("x", x), ("wq", wq)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (vector and TMA loads)")
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s_row = torch.empty((M,), dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = load_library().int8_matmul_fused_launch(
            x.data_ptr(), xq.data_ptr(), s_row.data_ptr(), wq.data_ptr(), ws.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), M, N, K,
            int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"int8_matmul_fused kernel launch failed: CUDA error {err}")
    int8_matmul_fused.launches += 1
    return out


int8_matmul_fused.launches = 0  # kernel launches since the last reset
