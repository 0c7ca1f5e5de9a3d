"""The benchmark's spans around the calls it makes into each layer.

Modes: "off" (the measured window of a `--trace 0` run: nothing recorded),
"timed" (the first part of a traced window: host walls with a device sync
at each boundary, device times from CUDA events) and "profiled" (the
profiled sub-window: `record_function("bench.<name>")` ranges only, so the
profiler names what the host was doing and nothing syncs).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self, device: torch.device):
        self.device = device
        self.mode = "off"
        self.host: dict[str, float] = defaultdict(float)  # seconds
        self._events: dict[str, list] = defaultdict(list)
        self._calls: dict[str, list] = defaultdict(list)  # name -> [(start, end, info)]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def host_span(self, name: str):
        """Host wall of the block, the device synced on entry and exit."""
        if self.mode == "timed":
            self._sync()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._sync()
                self.host[name] += time.perf_counter() - t0
        elif self.mode == "profiled":
            with torch.profiler.record_function("bench." + name):
                yield
        else:
            yield

    @contextlib.contextmanager
    def device_span(self, name: str):
        """Device time of the block from CUDA events (on the card only), the
        device synced on entry and exit."""
        if self.mode == "timed" and self.device.type == "cuda":
            self._sync()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            try:
                yield
            finally:
                b.record()
                self._events[name].append((a, b))
                self._sync()
        elif self.mode == "profiled":
            with torch.profiler.record_function("bench." + name):
                yield
        else:
            yield

    def device_seconds(self) -> dict[str, float]:
        """Sum of each device span in seconds (syncs first)."""
        self._sync()
        return {k: sum(a.elapsed_time(b) for a, b in v) / 1e3 for k, v in self._events.items()}

    def timed_call(self, name: str, fn, describe):
        """Wrap a function of the program: in "timed" mode each call is timed
        by CUDA events and kept with `describe(args, kwargs, output)`, what
        a metric reader needs of that call (its shapes, say)."""
        spans = self

        def timed(*args, **kw):
            if spans.mode == "profiled":
                with torch.profiler.record_function("bench." + name):
                    return fn(*args, **kw)
            if spans.mode != "timed" or spans.device.type != "cuda":
                return fn(*args, **kw)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            spans._calls[name].append((a, b, describe(args, kw, out)))
            return out

        return timed

    def call_records(self) -> dict[str, list[tuple[float, dict]]]:
        """Each timed call -> (device seconds, its description) (syncs first)."""
        self._sync()
        return {k: [(a.elapsed_time(b) / 1e3, info) for a, b, info in v]
                for k, v in self._calls.items()}
