"""Reading a torch.profiler capture from its raw kineto events.

`prof.events()` builds the profiler's Python event tree, which takes minutes
at 10^5 launches; the raw events take seconds. Host spans are the
benchmark's own `record_function("bench.<name>")` ranges, which kineto
stamps on the same clock as the device's activity.
"""

from __future__ import annotations

from collections import defaultdict

SPAN_PREFIX = "bench."


def raw_events(prof) -> tuple[list[tuple[int, int, str]], list[tuple[int, int, str]]]:
    """-> (device activity [(start_ns, end_ns, name)], benchmark host spans)."""
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.name().startswith(SPAN_PREFIX):
            # a host range; kineto also stamps its span on the device's timeline
            if e.device_type().name != "CUDA":
                spans.append((start, end, e.name()[len(SPAN_PREFIX):]))
        elif e.device_type().name == "CUDA":
            device.append((start, end, e.name()))
    return device, spans


def merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Union of intervals, sorted and disjoint."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(busy: list[tuple[int, int]], start: int, end: int) -> int:
    """ns of [start, end) that the disjoint `busy` intervals cover."""
    return sum(max(0, min(e, end) - max(s, start)) for s, e in busy)


def innermost(spans: list[tuple[int, int, str]], t: int) -> str:
    """Name of the shortest benchmark span holding time t ("none" if none)."""
    best = None
    for s, e, name in spans:
        if s <= t < e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "none"


def summarize(prof, window: str = "window") -> dict:
    """The profiled window's device busy and idle time, the busy share
    inside each benchmark span kind, the device operations that took most
    time and the longest idle gaps, each named by the innermost benchmark
    span the host was in."""
    device, spans = raw_events(prof)
    win = [(s, e) for s, e, n in spans if n == window]
    if not win:
        raise RuntimeError(f"no bench.{window} span in the profile")
    w0, w1 = min(s for s, _ in win), max(e for _, e in win)
    busy = merge([(max(s, w0), min(e, w1)) for s, e, _ in device if e > w0 and s < w1])
    busy_ns = sum(e - s for s, e in busy)
    by_op: dict[str, int] = defaultdict(int)
    for s, e, name in device:
        if e > w0 and s < w1:
            by_op[name] += min(e, w1) - max(s, w0)
    gaps = []
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((s - prev, innermost(spans, (s + prev) // 2)))
        prev = max(prev, e)
    span_busy: dict[str, list[int]] = defaultdict(lambda: [0, 0])
    for s, e, name in spans:
        if name != window:
            span_busy[name][0] += e - s
            span_busy[name][1] += covered(busy, s, e)
    kernels = sum(1 for s, e, name in device if e > w0 and s < w1
                  and not name.startswith(("Memcpy", "Memset")))
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernels": kernels,
        "span_busy": {k: (v[0] / 1e9, v[1] / 1e9) for k, v in span_busy.items()},
        "device_ops": [[n, t / 1e9] for n, t in sorted(by_op.items(), key=lambda x: -x[1])[:10]],
        "idle_gaps": [[n, t / 1e9] for t, n in sorted(gaps, key=lambda x: -x[0])[:10]],
    }
