"""Tracing/profiling helpers.

Port of `fluidaudio_tpu/utils/profiling.py` (reference os.signpost
intervals + per-stage wall timings + ANE profiling script, SURVEY §5):
a `torch.profiler` trace written as a Chrome trace, stage timers that
synchronise the CUDA stream before reading the clock, and per-device CUDA
memory stats.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path

import torch

from fluidaudio_tpu_torch.utils.logging import get_logger
from fluidaudio_tpu_torch.utils.timing import StageTimer

logger = get_logger("profiling")


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Profile the block with `torch.profiler` (CPU, and CUDA where torch
    sees a device) and write `<log_dir>/trace.json`, a Chrome trace
    (chrome://tracing, Perfetto); `log_dir=None` is `fluidaudio_trace` in
    the temporary directory. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    path = Path(log_dir) if log_dir else Path(tempfile.gettempdir()) / "fluidaudio_trace"
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path / "trace.json"))
    logger.info("trace written to %s", path / "trace.json")


@contextlib.contextmanager
def signpost(timer: StageTimer, name: str, block: bool = True):
    """Stage interval; with `block` it waits for the CUDA stream (when torch
    sees a device) before reading the clock, so the interval holds the
    device time of what the stage launched."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if block and torch.cuda.is_available():
            torch.cuda.synchronize()
        timer.add(name, time.perf_counter() - t0)


def device_memory_stats() -> dict:
    """`torch.cuda.memory_stats` per CUDA device, keyed "cuda:<i>"; {} when
    torch sees none."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
