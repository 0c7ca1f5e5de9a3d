"""Per-stage wall timing, performance metrics, and progress emission.

Behavioral parity: reference `Shared/PerformanceMetrics.swift:4-25`
(ASR timing struct), `Core/DiarizerTypes.swift:92-107` (`PipelineTimings` incl.
`bottleneckStage`), `Shared/ProgressEmitter.swift:3-55` (per-session progress
stream). On a GPU, callers end a timed stage with `torch.cuda.synchronize()`
so asynchronous launches don't hide device time.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Iterator


class StageTimer:
    """Accumulates named stage durations; `.measure("enc")` is a context manager."""

    def __init__(self) -> None:
        self.stages: dict[str, float] = {}

    @contextmanager
    def measure(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + seconds

    @property
    def total(self) -> float:
        return sum(self.stages.values())

    @property
    def bottleneck_stage(self) -> str | None:
        if not self.stages:
            return None
        return max(self.stages, key=self.stages.get)

    def summary(self) -> dict[str, float]:
        return dict(sorted(self.stages.items(), key=lambda kv: -kv[1]))


@dataclass
class PerformanceMetrics:
    """End-to-end timing for one inference call (reference ASRPerformanceMetrics)."""

    audio_seconds: float = 0.0
    preprocess_seconds: float = 0.0
    encode_seconds: float = 0.0
    decode_seconds: float = 0.0
    total_seconds: float = 0.0
    stages: dict[str, float] = field(default_factory=dict)

    @property
    def rtfx(self) -> float:
        """Real-time factor: audio seconds processed per wall second."""
        return self.audio_seconds / self.total_seconds if self.total_seconds > 0 else 0.0

    peak_memory_mb: float | None = None
    device_utilization_pct: float | None = None

    @property
    def summary_text(self) -> str:
        """Human-readable one-call summary (`ASRPerformanceMetrics.summary`,
        PerformanceMetricsTests.swift:10-44); absent device stats print N/A."""
        util = (
            f"{self.device_utilization_pct:.1f}%"
            if self.device_utilization_pct is not None
            else "N/A"
        )
        mem = (
            f"{self.peak_memory_mb:.1f} MB"
            if self.peak_memory_mb is not None
            else "N/A"
        )
        return (
            f"preprocess {self.preprocess_seconds:.3f}s | "
            f"encode {self.encode_seconds:.3f}s | "
            f"decode {self.decode_seconds:.3f}s | "
            f"total {self.total_seconds:.3f}s | "
            f"RTFx {self.rtfx:.1f} | peak mem {mem} | device util {util}"
        )


class ProgressSession:
    """One consumer-side progress stream (reference `ProgressEmitter.swift`
    AsyncStream session): iterating yields clamped fractions starting at 0.0;
    `finish` ends the stream after a final 1.0; `fail` re-raises the error in
    the consumer. Queue-backed so producers on other threads are safe."""

    _END = object()

    def __init__(self) -> None:
        import queue

        self._q: queue.Queue = queue.Queue()
        self._q.put(0.0)  # initial yield, reference ensureSession contract
        self.done = False

    def _push(self, item) -> None:
        if not self.done:
            self._q.put(item)

    def __iter__(self) -> Iterator[float]:
        while True:
            item = self._q.get()
            if item is ProgressSession._END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item


class ProgressEmitter:
    """Progress fan-out (0.0 → 1.0) for long-running jobs.

    Two consumption styles, both reference-parity
    (`Shared/ProgressEmitter.swift:3-55`): callback `subscribe`/`emit`, and
    the session stream `ensure_session()` → iterate → `finish_session()` /
    `fail_session(err)`. `emit` reports into the active session too, so
    manager code only calls one method.
    """

    def __init__(self) -> None:
        self._subscribers: list[Callable[[float], None]] = []
        self._session: ProgressSession | None = None

    def subscribe(self, fn: Callable[[float], None]) -> None:
        self._subscribers.append(fn)

    def ensure_session(self) -> ProgressSession:
        """Return the active session, creating one (first yield is 0.0)."""
        if self._session is None or self._session.done:
            self._session = ProgressSession()
        return self._session

    def emit(self, fraction: float) -> None:
        f = min(1.0, max(0.0, fraction))
        for fn in self._subscribers:
            fn(f)
        if self._session is not None:  # report without session: silently ignored
            self._session._push(f)

    report = emit  # reference naming

    def finish_session(self) -> None:
        if self._session is not None:
            self._session._push(1.0)
            self._session._push(ProgressSession._END)
            self._session.done = True
            self._session = None

    def fail_session(self, error: BaseException) -> None:
        if self._session is not None:
            self._session._push(error)
            self._session.done = True
            self._session = None
