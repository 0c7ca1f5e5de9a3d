#!/usr/bin/env python3
"""The f32 rel-pos attention kernels on one GPU: parity, then time per shape.

    python3 scripts/torch_attention_f32.py [--against OTHER.cu]

Builds `fluidaudio_tpu_torch/csrc/relpos_attention.cu` (and OTHER.cu, a
version of the same source with the same C interface, e.g. an earlier
commit's, when given) and prints what ptxas reports of the f32 kernels. Then
holds the repo's f32 kernels against the plain version over
`chip_smoke.f32_parity`'s sweep, and times them at the three f32 shapes
(Sortformer's offline windows B 16 x T 384 and streaming chunks B 1024 x
T 6 at H 8, Dh 64; the converted f32 v3 encoder's B 128 x T 188 at H 8,
Dh 128) in the encoder's form (strided f32 views in, an f32 view out, every
row full length), in turns: plain, kernel, other, kernel, other, plain
(`chip_smoke.kernel_ms`: CUDA-event means of calls queued behind a spin, so
the device time alone), each beside its bound at 67 TFLOP/s and 3.35 TB/s.
The other version's output is held against the plain version at each
timed shape too. Prints the card's name and power limit first. Needs one NVIDIA
GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    F32_FLOPS, SF_F32_TOL, attention_cost, attention_inputs, bound, f32_parity, kernel_ms,
    ptxas_report)
from fluidaudio_tpu_torch.ops import attention as attn  # noqa: E402
from fluidaudio_tpu_torch.ops import build  # noqa: E402

SHAPES = [(16, 8, 384, 64), (1024, 8, 6, 64), (128, 8, 188, 128)]  # B, H, T, Dh
KERNELS = ("relpos_attention_simt", "relpos_attention_short_simt")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, help="another relpos_attention.cu to time")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    device = torch.device("cuda", 0)
    sources = [attn.KERNEL_SOURCE] + ([args.against.resolve()] if args.against else [])
    built = {}
    for src in sources:  # one at a time: the two may share a file name
        built[src] = build.build(src)[src.name]
    for src, (sec, log) in built.items():
        reports = " || ".join(f"{name}: {ptxas_report(log, name) or '-'}" for name in KERNELS)
        print(f"[{smi}] {src.relative_to(src.parents[2]) if src == attn.KERNEL_SOURCE else src} "
              f"built in {sec:.2f} s | {reports}", flush=True)
    ours = attn.load_library()
    other = None
    if args.against:
        import ctypes

        other = ctypes.CDLL(str(build.library_path(args.against.resolve())))
        other.relpos_attention_launch.argtypes = ours.relpos_attention_launch.argtypes
        other.relpos_attention_launch.restype = ours.relpos_attention_launch.restype

    err, summary = f32_parity(attn, device)
    print(f"[{smi}] parity of this source's f32 kernels: {summary}", flush=True)

    def run_with(lib, fn):
        saved = attn.load_library
        attn.load_library = lambda: lib
        try:
            return fn()
        finally:
            attn.load_library = saved

    for B, H, T, Dh in SHAPES:
        lens = torch.full((B,), T, dtype=torch.int32, device=device)
        qu, qw, k, v, p = attention_inputs(B, H, T, Dh, torch.float32, device, seed=16,
                                           strided=True)
        out = torch.empty(B, T, H, Dh, device=device).transpose(1, 2)
        kernel = lambda: attn.relpos_attention(qu, qw, k, v, p, lens, T, out=out)
        plain = lambda: attn.relpos_attention_plain(qu, qw, k, v, p, lens, T)
        want = plain()
        errs = {"kernel": (kernel() - want).abs().max().item()}
        times = {"plain": [kernel_ms(plain)], "kernel": []}
        if other is not None:
            errs["other"] = run_with(other, lambda: (kernel() - want).abs().max().item())
            times["other"] = []
        for _ in range(2):
            times["kernel"].append(kernel_ms(kernel))
            if other is not None:
                times["other"].append(run_with(other, lambda: kernel_ms(kernel)))
        times["plain"].append(kernel_ms(plain))
        nbytes, ops = attention_cost(B, H, T, Dh, 4, 4)
        bound_ms, bound_by = bound(nbytes, ops, F32_FLOPS)
        parts = [f"{name} {'/'.join(f'{t:.4f}' for t in ts)} ms"
                 + (f" ({bound_ms / min(ts):.1%} of bound, max abs err {errs[name]:.2e})"
                    if name in errs else "")
                 for name, ts in times.items()]
        print(f"[{smi}] f32 B={B} H={H} T={T} Dh={Dh} (encoder form): {' | '.join(parts)} | "
              f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} GFLOP)", flush=True)
        if errs["kernel"] > SF_F32_TOL:
            print(f"kernel max abs err {errs['kernel']} > {SF_F32_TOL}", file=sys.stderr)
            return 1
        del qu, qw, k, v, p, out, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
