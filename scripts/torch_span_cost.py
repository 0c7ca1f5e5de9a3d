#!/usr/bin/env python3
"""What the port's spans (`utils/profiling.py::span`) cost on the GPU.

    python3 scripts/torch_span_cost.py [--runs 3] [--seed 0]

Builds `SortformerDiarizer` at SORTFORMER_V2 with seeded random weights,
makes 8 recordings of 5-30 min (log-spaced, int16 noise), runs each window
bucket once, then times `process_offline` request by request: runs with no
profiler and runs inside `profiling.trace()`, alternating (off, on, on,
off, ...). Prints per run the median request wall per minute of audio, and
then the cost of one empty span by the host clock over 10,000 spans: with
no profiler, and inside a profiler with a CUDA device given and without.
Prints the card's name and power limit first. Needs one NVIDIA GPU;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fluidaudio_tpu_torch.diarizer.sortformer import SortformerDiarizer  # noqa: E402
from fluidaudio_tpu_torch.models.sortformer import SORTFORMER_V2  # noqa: E402
from fluidaudio_tpu_torch.utils import profiling  # noqa: E402

SIZES_S = np.geomspace(300, 1800, 8)
SPANS = 10_000


def one_run(d: SortformerDiarizer, recordings: list[np.ndarray]) -> float:
    """Median over the recordings of request wall ms per minute of audio."""
    per_min = []
    for x in recordings:
        t0 = time.perf_counter()
        d.process_offline(x)
        per_min.append((time.perf_counter() - t0) * 1e3 / (x.size / 16000 / 60))
    return statistics.median(per_min)


def span_cost_us(dev: torch.device | None) -> float:
    t0 = time.perf_counter()
    for _ in range(SPANS):
        with profiling.span("x", device=dev):
            pass
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / SPANS


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    d = SortformerDiarizer(SORTFORMER_V2, rng_seed=args.seed, device=dev)
    rs = np.random.default_rng(args.seed)
    recordings = [(rs.standard_normal(int(s * 16000)) * 3000).astype(np.int16) for s in SIZES_S]
    for x in recordings:  # every bucket once
        d.process_offline(x)
    torch.cuda.synchronize()
    walls: dict[str, list[float]] = {"off": [], "trace": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.runs):
            for mode in (("off", "trace") if i % 2 == 0 else ("trace", "off")):
                if mode == "off":
                    walls[mode].append(one_run(d, recordings))
                else:
                    profiling.reset()
                    with profiling.trace(Path(tmp) / f"{i}"):
                        walls[mode].append(one_run(d, recordings))
                    n = sum(v["count"] for v in profiling.summary().values())
                    print(f"run {i} trace: {n} spans recorded")
    for mode, v in walls.items():
        print(f"{mode}: request wall ms per audio minute, median of the 8 requests, per run: "
              + ", ".join(f"{x:.4f}" for x in v) + f"; median {statistics.median(v):.4f}")
    off_us = span_cost_us(dev)
    on_us = {}
    for device in (dev, None):
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            on_us[device] = span_cost_us(device)
    profiling.reset()
    print(f"one span (host clock over {SPANS}): {off_us:.3f} us with no profiler; under the "
          f"profiler {on_us[dev]:.3f} us with two CUDA events, {on_us[None]:.3f} us host only")


if __name__ == "__main__":
    main()
