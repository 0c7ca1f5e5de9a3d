"""Sliding-window buffer for real-time audio streams.

Behavioral parity with the reference `Shared/AudioStream.swift:5-506`:

  - chunk geometry from (chunk_duration, chunk_skip): overlapping chunks of
    ``chunk_size`` samples whose starts are ``skip_size`` apart
  - chunking strategies (`AudioStream.swift:489-496`): ``fixed_skip`` keeps a
    constant skip between chunk starts even when the producer overruns;
    ``most_recent`` forms each chunk from the newest samples (may jump ahead
    under overload, dropping old audio)
  - startup strategies (`AudioStream.swift:498-506`): ``start_silent``
    (implicit leading silence so the first chunk fires after ``chunk_skip``
    seconds), ``ramp_up`` (chunk grows by ``skip_size`` per read until full),
    ``wait_full`` (no chunk until a full one is buffered)
  - time-based resynchronization on write (`AudioStream.swift:316-323`): a
    forward timestamp jump zero-fills the gap, a backward one rolls back the
    newest samples
  - bound callbacks fired from ``write`` whenever chunks become ready
    (`AudioStream.swift:331-337`), or pull-mode ``read_chunk_if_available``

Host-side pure Python/numpy — the consumer (VAD/ASR manager) owns the device
work; this class only assembles aligned windows.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class AudioStreamError(ValueError):
    pass


class AudioStream:
    """Overlapping-chunk assembler over a bounded sliding buffer."""

    def __init__(
        self,
        chunk_duration: float = 10.0,
        chunk_skip: float | None = None,
        stream_start_time: float = 0.0,
        chunking_strategy: str = "most_recent",  # or "fixed_skip"
        startup_strategy: str = "start_silent",  # "ramp_up" | "wait_full"
        sample_rate: float = 16_000.0,
        buffer_capacity_seconds: float | None = None,
    ):
        if chunk_duration <= 0:
            raise AudioStreamError("invalid chunk duration")
        chunk_skip = chunk_duration if chunk_skip is None else chunk_skip
        if chunk_skip <= 0 or chunk_skip > chunk_duration:
            raise AudioStreamError("invalid chunk skip")
        if chunking_strategy not in ("most_recent", "fixed_skip"):
            raise AudioStreamError(f"unknown chunking strategy {chunking_strategy!r}")
        if startup_strategy not in ("start_silent", "ramp_up", "wait_full"):
            raise AudioStreamError(f"unknown startup strategy {startup_strategy!r}")

        self.sample_rate = float(sample_rate)
        self.chunk_duration = float(chunk_duration)
        self.chunk_skip = float(chunk_skip)
        self.chunk_size = int(round(sample_rate * chunk_duration))
        self.skip_size = int(round(sample_rate * self.chunk_skip))
        self.chunking_strategy = chunking_strategy

        cap_s = buffer_capacity_seconds
        capacity = int(round((cap_s if cap_s is not None else chunk_duration + self.chunk_skip) * sample_rate))
        if capacity < self.chunk_size:
            raise AudioStreamError("buffer too small")
        self._buf = np.zeros(capacity, np.float32)

        self._callback: Callable[[np.ndarray, float], None] | None = None
        if startup_strategy == "start_silent":
            self._write_index = self.chunk_size - self.skip_size
            self._tmp_chunk_size = self.chunk_size
            self._buffer_start_time = stream_start_time - (chunk_duration - self.chunk_skip)
        elif startup_strategy == "ramp_up":
            self._write_index = 0
            self._tmp_chunk_size = self.skip_size
            self._buffer_start_time = stream_start_time
        else:  # wait_full
            self._write_index = 0
            self._tmp_chunk_size = self.chunk_size
            self._buffer_start_time = stream_start_time

    # ------------------------------------------------------------- props

    @property
    def overlap_size(self) -> int:
        return self.chunk_size - self.skip_size

    @property
    def chunk_overlap(self) -> float:
        return self.chunk_duration - self.chunk_skip

    @property
    def has_new_chunk(self) -> bool:
        return self._write_index >= self._tmp_chunk_size

    # ---------------------------------------------------------- bindings

    def bind(self, callback: Callable[[np.ndarray, float], None]) -> None:
        """Fire ``callback(chunk, chunk_start_time)`` from within ``write``
        whenever a chunk becomes ready (possibly several per write)."""
        self._callback = callback

    def unbind(self) -> None:
        self._callback = None

    # ------------------------------------------------------------- write

    def write(self, samples: np.ndarray, at_time: float | None = None) -> None:
        """Append samples; ``at_time`` (seconds, end-of-samples timestamp)
        resynchronizes: forward jumps zero-fill, backward jumps roll back."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        if at_time is not None:
            # resynchronize even for a pure-timestamp (empty) write — a
            # producer may signal a dropout gap with zero samples
            start_index = int(round(self._buffer_start_time * self.sample_rate))
            end_index = start_index + self._write_index + samples.size
            expected_end = int(round(at_time * self.sample_rate))
            deviation = expected_end - end_index
            if deviation > 0:
                self._append_zeros(deviation, before_adding=samples.size)
            elif deviation < 0:
                self._rollback_newest(-deviation)
        if samples.size:
            self._append(samples)

        while self._callback is not None and self.has_new_chunk:
            chunk, ts = self.read_chunk_if_available()  # type: ignore[misc]
            self._callback(chunk, ts)

    # -------------------------------------------------------------- read

    def read_chunk_if_available(self) -> tuple[np.ndarray, float] | None:
        """Pop the next ready ``(chunk, chunk_start_time)`` or None."""
        if not self.has_new_chunk:
            return None
        if self.chunking_strategy == "most_recent":
            start = self._write_index - self._tmp_chunk_size
            ts = self._buffer_start_time + start / self.sample_rate
            chunk = self._buf[start : self._write_index].copy()
        else:  # fixed_skip
            chunk = self._buf[: self._tmp_chunk_size].copy()
            ts = self._buffer_start_time

        if self._tmp_chunk_size == self.chunk_size:
            if self.chunking_strategy == "most_recent":
                self._forget_oldest(self._write_index - self.overlap_size)
            else:
                self._forget_oldest(self.skip_size)
        else:  # still ramping up
            self._tmp_chunk_size = min(self._tmp_chunk_size + self.skip_size, self.chunk_size)
        return chunk, ts

    def with_chunk_if_available(self, body: Callable[[np.ndarray, float], object]):
        got = self.read_chunk_if_available()
        return None if got is None else body(*got)

    # ----------------------------------------------------------- helpers

    def _rollback_newest(self, count: int) -> None:
        self._write_index -= count
        if self._write_index < 0:
            self._buffer_start_time += self._write_index / self.sample_rate
            self._write_index = 0

    def _forget_oldest(self, count: int) -> None:
        if count < self._write_index:
            self._buf[: self._write_index - count] = self._buf[count : self._write_index]
        self._write_index -= count
        self._buffer_start_time += count / self.sample_rate

    def _prepare_append(self, count: int, max_write_index: int, shifted_write_index: int) -> int:
        """Trim/shift so ``count`` incoming samples fit; -> samples to add."""
        after = self._write_index + count
        if after > max_write_index:
            self._forget_oldest(after - shifted_write_index)
            after = shifted_write_index
        if after <= 0:  # entire source precedes the buffer
            self._write_index = after
            return 0
        if self._write_index < 0:
            n_forget = -self._write_index
            self._write_index = 0
            return count - n_forget
        return count

    def _append(self, samples: np.ndarray) -> None:
        cap = self._buf.size
        shifted = self._tmp_chunk_size if self.chunking_strategy == "most_recent" else cap
        n = self._prepare_append(samples.size, cap, shifted)
        if n <= 0:
            return
        src = samples[samples.size - n :]
        self._buf[self._write_index : self._write_index + n] = src
        self._write_index += n

    def _append_zeros(self, count: int, before_adding: int) -> None:
        cap = self._buf.size
        shifted = (
            self._tmp_chunk_size - before_adding
            if self.chunking_strategy == "most_recent"
            else cap - before_adding
        )
        n = self._prepare_append(count, cap - before_adding, shifted)
        if n <= 0:
            return
        self._buf[self._write_index : self._write_index + n] = 0.0
        self._write_index += n


class AudioRingBuffer:
    """Ring buffer with absolute-time indexing and gap zero-fill (the
    round-1 `AudioStream`; kept for consumers that address samples by
    absolute stream position rather than chunk callbacks)."""

    def __init__(self, capacity_samples: int = 16_000 * 120, sample_rate: int = 16_000):
        self.capacity = capacity_samples
        self.sample_rate = sample_rate
        self._buf = np.zeros(capacity_samples, np.float32)
        self._start = 0  # absolute index of _buf position 0's logical sample
        self._end = 0  # absolute index one past the last written sample

    @property
    def start_index(self) -> int:
        return self._start

    @property
    def end_index(self) -> int:
        return self._end

    @property
    def available(self) -> int:
        return self._end - self._start

    def append(self, samples: np.ndarray, at_index: int | None = None) -> None:
        """Append at the stream end, or at an absolute index (gap zero-filled)."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        pos = self._end if at_index is None else at_index
        if pos > self._end:
            self._write(np.zeros(pos - self._end, np.float32), self._end)
        self._write(samples, pos)

    def _write(self, samples: np.ndarray, pos: int) -> None:
        n = samples.size
        if n == 0:
            return
        end = pos + n
        if end - self._start > self.capacity:
            self._start = end - self.capacity
        if n >= self.capacity:
            self._buf[(np.arange(end - self.capacity, end)) % self.capacity] = samples[
                -self.capacity :
            ]
            self._end = end
            return
        idx = (np.arange(pos, end)) % self.capacity
        self._buf[idx] = samples
        self._end = max(self._end, end)

    def read(self, start: int, count: int) -> np.ndarray:
        """Read absolute range [start, start+count); out-of-window is zeros."""
        out = np.zeros(count, np.float32)
        lo = max(start, self._start)
        hi = min(start + count, self._end)
        if hi > lo:
            idx = np.arange(lo, hi) % self.capacity
            out[lo - start : hi - start] = self._buf[idx]
        return out

    def read_latest(self, count: int) -> np.ndarray:
        return self.read(max(self._start, self._end - count), count)

    def chunks(self, chunk_size: int, hop: int | None = None):
        """Iterate fixed/sliding windows over the available range."""
        hop = hop or chunk_size
        pos = self._start
        while pos + chunk_size <= self._end:
            yield pos, self.read(pos, chunk_size)
            pos += hop
