#!/usr/bin/env python3
"""Device-time breakdown of one Parakeet TDT v3 encoder call on the GPU,
bf16 and int8, with the PyTorch port.

    python3 scripts/torch_encoder_profile.py [--batch 128]

Loads v3 at full width (24 x 1024) with seeded random weights twice, bf16
and quantization="int8" (same seed, so the same f32 weights), pushes one
batch of 15 s windows through the mel frontend, and profiles one encoder
call of each with `torch.profiler`: device time by kernel group and for the
top kernels, the total device time, the host wall time of the call, and the
device's idle share over the call's span. Beside it, each hand-written
kernel's launches and summed bound in that call, from the shapes the layers
see (bytes over the HBM rate or operations over the peak, as `chip_smoke.py`
reckons them), and for the int8 encoder each layer shape's GEMM and
row-quantise device time. Prints the card's name and power limit first.
Needs one NVIDIA GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    BF16_FLOPS, HBM_BYTES_PER_S, INT8_OPS, attention_cost, bound, int8_cost)
from fluidaudio_tpu_torch.models.conformer import RelPosMHSA  # noqa: E402
from fluidaudio_tpu_torch.models.zoo import AsrModels  # noqa: E402
from fluidaudio_tpu_torch.ops.quant import Int8Linear  # noqa: E402

# kernel-name substrings -> group, first match wins
GROUPS = [("int8_gemm_dequant", "int8 GEMM + dequant (ours)"),
          ("quantize_rows", "int8 row quantise (ours)"),
          ("relpos", "rel-pos attention (ours)"),
          ("conv", "convolution"),  # before "gemm": cuDNN's implicit_convolve_sgemm
          ("nvjet", "cuBLAS GEMM"), ("gemm", "cuBLAS GEMM"), ("norm", "LayerNorm"),
          ("elementwise", "elementwise"), ("reduce", "reduction")]


def group_of(name: str) -> str:
    low = name.lower()
    return next((g for key, g in GROUPS if key in low), "other")


def speechlike(rs: np.random.RandomState, seconds: float) -> np.ndarray:
    t = np.arange(int(seconds * 16_000)) / 16_000.0
    am = 0.5 * (1.0 + np.sin(2 * np.pi * 4.0 * t))
    return (rs.randn(t.size) * 0.1 * am).astype(np.float32)


def busy_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def kernel_bounds(models, mel, mel_len
                  ) -> tuple[dict[str, tuple[int, float, float, float]], list[tuple[int, int, int]]]:
    """Run one encoder call with hooks on the layers that launch our kernels
    -> ({kernel: (launches, bound ms, bytes ms, operations ms)}, each summed
    over the launches (every row full length, so every key counts); the
    (M, K, N) of every int8 layer in call order)."""
    shapes = {"relpos_attention": [], "int8_matmul_fused": []}
    int8_shapes = []

    def on_attention(mod, args):
        B, T, d = args[0].shape
        # the encoder's call writes its output in the compute dtype (bf16)
        cost = attention_cost(B, mod.n_heads, T, d // mod.n_heads, args[0].element_size())
        shapes["relpos_attention"].append((*cost, BF16_FLOPS))

    def on_int8(mod, args):
        x = args[0]
        K = x.shape[-1]
        cost = int8_cost(x.numel() // K, K, mod.out_features, mod.bias is not None,
                         x.element_size(), torch.finfo(mod.out_dtype).bits // 8)
        shapes["int8_matmul_fused"].append((*cost, INT8_OPS))
        int8_shapes.append((x.numel() // K, K, mod.out_features))

    hooks = [m.register_forward_pre_hook(on_attention if isinstance(m, RelPosMHSA) else on_int8)
             for m in models.encoder.modules() if isinstance(m, (RelPosMHSA, Int8Linear))]
    try:
        models.encoder(mel, mel_len)
    finally:
        for h in hooks:
            h.remove()
    out = {}
    for name, launches in shapes.items():
        if launches:
            out[name] = (len(launches),
                         sum(bound(b, o, peak)[0] for b, o, peak in launches),
                         sum(b / HBM_BYTES_PER_S * 1e3 for b, _, _ in launches),
                         sum(o / peak * 1e3 for _, o, peak in launches))
    return out, int8_shapes


def print_int8_by_shape(kernels, shapes: list[tuple[int, int, int]]) -> None:
    """Device time of the int8 kernel's two launches by layer shape: the
    profiled launches, in start order, belong to the int8 layers in call
    order."""
    per = defaultdict(lambda: defaultdict(float))
    for key in ("int8_gemm_dequant", "quantize_rows"):
        events = sorted((e for e in kernels if key in e.name), key=lambda e: e.time_range.start)
        if len(events) != len(shapes):
            raise SystemExit(f"{len(events)} {key} launches for {len(shapes)} int8 layers")
        for shape, e in zip(shapes, events):
            per[shape][key] += e.time_range.elapsed_us()
    for (M, K, N), n in Counter(shapes).items():
        t = per[(M, K, N)]
        print(f"  int8   M={M} K={K} N={N}: {n} launches, GEMM "
              f"{t['int8_gemm_dequant'] / n:.1f} us each ({t['int8_gemm_dequant'] / 1e3:.3f} ms; "
              f"operations alone {2 * M * K * N / INT8_OPS * 1e6:.1f} us), row quantise "
              f"{t['quantize_rows'] / n:.1f} us each ({t['quantize_rows'] / 1e3:.3f} ms)")


def profile_encoder(models, mel, mel_len, label: str, smi: str) -> None:
    for _ in range(2):
        models.encoder(mel, mel_len)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        models.encoder(mel, mel_len)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise SystemExit("the profiler recorded no device time")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    by_name, by_group, count = defaultdict(float), defaultdict(float), defaultdict(int)
    for e in kernels:
        dur = e.time_range.elapsed_us() / 1e3
        by_name[e.name] += dur
        by_group[group_of(e.name)] += dur
        count[e.name] += 1
    device_ms = sum(by_name.values())
    span_ms = (max(s[1] for s in spans) - min(s[0] for s in spans)) / 1e3
    idle = 1.0 - busy_us(spans) / 1e3 / span_ms
    print(f"[{smi}] {label}: device {device_ms:.2f} ms in {len(kernels)} kernels, host wall "
          f"{wall_ms:.2f} ms (profiler on), kernel span {span_ms:.2f} ms, idle share of the "
          f"span {idle:.3f}")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  group {g:28s} {ms:9.3f} ms  {ms / device_ms:6.1%}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  kernel {ms:9.3f} ms x{count[name]:<5d} {name[:90]}")
    bounds, int8_shapes = kernel_bounds(models, mel, mel_len)
    for name, (n, bound_ms, bytes_ms, ops_ms) in bounds.items():
        print(f"  bound  {name}: {n} launches, summed bound {bound_ms:.3f} ms "
              f"(bytes alone {bytes_ms:.3f} ms, operations alone {ops_ms:.3f} ms)")
    if int8_shapes:
        print_int8_by_shape(kernels, int8_shapes)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    device = torch.device("cuda", 0)
    rs = np.random.RandomState(3)
    audio = torch.from_numpy(np.stack([speechlike(rs, 15.0) for _ in range(args.batch)]))
    lengths = torch.full((args.batch,), 240_000, dtype=torch.int32)
    for quantization in ("none", "int8"):
        models = AsrModels.load("v3", device=device, allow_random_init=True, rng_seed=0,
                                quantization=quantization)
        mel, mel_len = models.mel(audio.to(device), lengths.to(device))
        profile_encoder(models, mel, mel_len,
                        f"v3 encoder {quantization} B={args.batch} 15 s", smi)
        del models
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
