#!/usr/bin/env python3
"""What the rel-pos attention kernel's time is made of, on one GPU.

    python3 scripts/torch_attention_probe.py

Times the kernel (`fluidaudio_tpu_torch/ops/attention.py`, the encoder's
call form: strided bf16 views in, a bf16 view out, every row full length)
at H=8, Dh=128 over T = 64 .. 512, with the batch chosen so that every T
launches about the same number of blocks as the v3 encoder's call (3,072
blocks of 64 query rows). The kernel runs two blocks per SM, so each SM
holds ~blocks / 264 blocks in turn; the time per block on an SM against
its number of 32-key tiles (T / 32) fits a line whose intercept is the
fixed cost of a block (loading qu and qw, the first tile's wait, the
epilogue) and whose slope is the cost of a key tile. Beside the slope: the
tensor-core time of one tile's products at the bf16 peak, and the time of
its TMA bytes at the HBM rate, both per SM. Prints the card's name and
power limit first. Needs one NVIDIA GPU; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    BF16_FLOPS, HBM_BYTES_PER_S, attention_cost, attention_inputs, bf16_out, bound, cuda_ms)
from fluidaudio_tpu_torch.ops import attention as attn  # noqa: E402

H, DH, Q_ROWS, KEYS = 8, 128, 64, 32
BLOCKS = 3 * H * 128  # the v3 encoder's call: 3 query blocks x 8 heads x B=128


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = []
    for T in (64, 128, 192, 256, 384, 512):
        q_blocks = -(-T // Q_ROWS)
        B = BLOCKS // (H * q_blocks)
        qu, qw, k, v, p = attention_inputs(B, H, T, DH, torch.bfloat16, device, seed=4,
                                           strided=True)
        lens = torch.full((B,), T, dtype=torch.int32, device=device)
        out = bf16_out(B, H, T, DH, device)
        ms = min(cuda_ms(lambda: attn.relpos_attention(qu, qw, k, v, p, lens, T, out=out))
                 for _ in range(2))
        blocks = q_blocks * H * B
        per_block_us = ms * 1e3 / (blocks / (2 * sms))  # two blocks per SM at a time
        nbytes, ops = attention_cost(B, H, T, DH, 2)
        bound_ms, bound_by = bound(nbytes, ops, BF16_FLOPS)
        rows.append((T // KEYS, per_block_us))
        print(f"[{smi}] T={T} B={B} blocks={blocks}: {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), {bound_ms / ms:.0%} of it | {per_block_us:.2f} us per block on "
              f"an SM ({T // KEYS} key tiles)", flush=True)
        del qu, qw, k, v, p, out
    tiles, us = (np.array(c, dtype=np.float64) for c in zip(*rows))
    slope, intercept = np.polyfit(tiles, us, 1)
    # one key tile of one block: (q+u)K^T (64 x 32), (q+w) x band (64 x 96), P.V (64 x 32)
    tile_flops = 2 * Q_ROWS * (KEYS + 96 + KEYS) * DH
    tile_bytes = 3 * KEYS * DH * 2  # K, V and one new 32-row p chunk
    print(f"[{smi}] fit over T: {intercept:.2f} us per block + {slope:.3f} us per key tile "
          f"(two blocks share an SM) | per SM, one tile's products take "
          f"{tile_flops / (BF16_FLOPS / sms) * 1e6:.3f} us at the bf16 peak and its TMA bytes "
          f"{tile_bytes / (HBM_BYTES_PER_S / sms) * 1e6:.3f} us at the HBM rate")
    return 0


if __name__ == "__main__":
    sys.exit(main())
