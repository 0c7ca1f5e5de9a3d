"""Tracing/profiling helpers.

Port of `fluidaudio_tpu/utils/profiling.py` (reference os.signpost
intervals + per-stage wall timings + ANE profiling script, SURVEY §5):

- `span`: the program's own named intervals, with counts, nested per
  thread and grouped by request. A span records only while a torch
  profiler records (the repo's `trace()`, any `torch.profiler.profile`);
  otherwise it costs one flag check. Records stay in this module's memory,
  stamped on the clock kineto stamps its events with, and never open a
  `record_function`: kineto would stamp such a range on the device's
  timeline too, where it would read as device activity.
- `spans`, `summary`, `reset`, `dropped`: the records since the last
  `reset()`, and per name their count, host, self and device seconds and
  summed counts.
- `trace`: a `torch.profiler` Chrome trace with the spans merged in.
- `device_memory_stats`: per-device CUDA memory stats.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("profiling")

MAX_SPANS = 65_536


@dataclass
class Span:
    """One span: host stamps in Unix ns (kineto's clock), the outermost
    span's id as `request`, the enclosing span's id as `parent`, its
    counts, and on a CUDA device a pair of timing events on the device's
    current stream. Yielded by `span` as the handle of the open block."""

    name: str
    id: int
    request: int
    parent: int | None
    thread: int
    start_ns: int = 0
    end_ns: int = 0
    counts: dict = field(default_factory=dict)
    device: torch.device | None = None
    events: tuple | None = None

    def set(self, **counts) -> None:
        """Keep these counts with the span (a later value replaces an earlier one)."""
        self.counts.update(counts)

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Off:
    """The handle of a span opened while no profiler records."""

    def set(self, **counts) -> None:
        pass


_OFF = _Off()


class Tracer:
    """The spans of one process, oldest dropped past `cap`. One instance
    serves the process, as the profiler it follows does (`span` and the
    functions below)."""

    def __init__(self, cap: int = MAX_SPANS):
        self._records: collections.deque[Span] = collections.deque(maxlen=cap)
        self._dropped = 0
        self._next_id = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    @contextlib.contextmanager
    def span(self, name: str, *, device=None, **counts):
        """Record the block as span `name` with `counts` (more can be set on
        the yielded handle), while a torch profiler records; `device`, when
        a CUDA device, also times the block there with CUDA events, read
        without a sync at `summary()`."""
        if not torch.autograd._profiler_enabled():
            yield _OFF
            return
        stack = self._local.__dict__.setdefault("stack", [])
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        parent = stack[-1] if stack else None
        rec = Span(name, sid, parent[0].request if parent else sid,
                   parent[0].id if parent else None, threading.get_native_id(),
                   counts=dict(counts))
        # Unix ns from the monotonic clock plus one offset per request
        offset = parent[1] if parent else time.time_ns() - time.perf_counter_ns()
        if device is not None and (device := torch.device(device)).type == "cuda":
            rec.device = device
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
        stack.append((rec, offset))
        rec.start_ns = offset + time.perf_counter_ns()
        if rec.events:
            rec.events[0].record(torch.cuda.current_stream(rec.device))
        try:
            yield rec
        finally:
            if rec.events:
                rec.events[1].record(torch.cuda.current_stream(rec.device))
            rec.end_ns = offset + time.perf_counter_ns()
            stack.pop()
            with self._lock:
                if len(self._records) == self._records.maxlen:
                    self._dropped += 1
                self._records.append(rec)

    def spans(self) -> list[Span]:
        """The closed spans since the last `reset()`, in the order they closed."""
        with self._lock:
            return list(self._records)

    def dropped(self) -> int:
        """Spans dropped since the last `reset()` to keep the newest `cap`."""
        return self._dropped

    def next_id(self) -> int:
        """The id the next span will take."""
        return self._next_id

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._dropped = 0

    def summary(self) -> dict[str, dict]:
        """Per span name: `count`, `host_s`, `self_s` (host seconds less the
        time its child spans cover), `device_s` (CUDA events, read after one
        synchronize per device; None where no span of the name had them) and
        the summed `counts`."""
        records = self.spans()
        for dev in {r.device for r in records if r.events}:
            torch.cuda.synchronize(dev)
        children: dict[int, int] = collections.defaultdict(int)
        for r in records:
            if r.parent is not None:
                children[r.parent] += r.end_ns - r.start_ns
        out: dict[str, dict] = {}
        for r in records:
            s = out.setdefault(r.name, {"count": 0, "host_s": 0.0, "self_s": 0.0,
                                        "device_s": None, "counts": {}})
            s["count"] += 1
            s["host_s"] += r.host_s
            s["self_s"] += (r.end_ns - r.start_ns - children[r.id]) / 1e9
            if r.events:
                s["device_s"] = (s["device_s"] or 0.0) + r.events[0].elapsed_time(r.events[1]) / 1e3
            for k, v in r.counts.items():
                s["counts"][k] = s["counts"].get(k, 0) + v
        return out


TRACER = Tracer()
span = TRACER.span
spans = TRACER.spans
summary = TRACER.summary
reset = TRACER.reset
dropped = TRACER.dropped


def _merge_spans(trace_file: Path, records: list[Span]) -> None:
    """Add each span to the Chrome trace as a complete event on its host
    thread's track, on the clock of the trace's own events."""
    with open(trace_file) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    for dev in {r.device for r in records if r.events}:
        torch.cuda.synchronize(dev)
    pid = os.getpid()
    for r in records:
        args = {"id": r.id, "request": r.request, "parent": r.parent, **r.counts}
        if r.events:
            args["device_ms"] = r.events[0].elapsed_time(r.events[1])
        doc["traceEvents"].append({
            "ph": "X", "cat": "fluidaudio_span", "name": r.name, "pid": pid, "tid": r.thread,
            "ts": (r.start_ns - base) / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3, "args": args})
    with open(trace_file, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Profile the block with `torch.profiler` (CPU, and CUDA where torch
    sees a device) and write `<log_dir>/trace.json`, a Chrome trace
    (chrome://tracing, Perfetto) holding the block's spans beside the
    profiler's events; `log_dir=None` is a new temporary directory on each
    call. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    path = Path(log_dir) if log_dir else Path(tempfile.mkdtemp(prefix="fluidaudio_trace_"))
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    first = TRACER.next_id()
    with profile(activities=activities) as prof:
        yield prof
    out = path / "trace.json"
    prof.export_chrome_trace(str(out))
    _merge_spans(out, [r for r in TRACER.spans() if r.id >= first])
    if TRACER.dropped():
        logger.warning("%d spans dropped (more than %d kept)", TRACER.dropped(), MAX_SPANS)
    logger.info("trace written to %s", out)


def device_memory_stats() -> dict:
    """`torch.cuda.memory_stats` per CUDA device, keyed "cuda:<i>"; {} when
    torch sees none."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
