"""StreamingChunkQueue: buffer samples, emit whole [left|chunk|right] windows.

Behavioral parity: reference `LS-EEND/StreamingChunkQueue.swift` (exercised
by `LSEENDQueueTests.swift`): a chunk becomes ready only when `chunk_length +
right_context` elements past the consumed point are buffered; the first
window's left context is zero-filled, later windows re-read the tail of
already-consumed audio. Consumers that zero-pad partial tails distort
streaming predictions — the queue defers the tail to the next append (or an
explicit `pop_tail` at finalization).
"""

from __future__ import annotations

import numpy as np


class StreamingChunkQueue:
    def __init__(self, chunk_length: int, left_context: int = 0,
                 right_context: int = 0, stride: int = 1):
        if chunk_length < 1 or stride < 1:
            raise ValueError("chunk_length and stride must be >= 1")
        self.chunk = chunk_length * stride
        self.left = left_context * stride
        self.right = right_context * stride
        self._buf = np.zeros(0, np.float32)
        self._consumed = 0  # elements already emitted as chunk bodies

    def append(self, samples) -> None:
        x = np.asarray(samples, np.float32).reshape(-1)
        if x.size:
            self._buf = np.concatenate([self._buf, x])

    @property
    def ready_chunks(self) -> int:
        return max(0, (self._buf.size - self._consumed - self.right) // self.chunk)

    @property
    def has_chunk(self) -> bool:
        return self.ready_chunks > 0

    @property
    def pending(self) -> int:
        """Elements buffered but not yet emitted as a chunk body."""
        return self._buf.size - self._consumed

    def _window(self, n_chunks: int) -> np.ndarray:
        start = self._consumed - self.left
        end = self._consumed + n_chunks * self.chunk + self.right
        head = np.zeros(max(0, -start), np.float32)  # first-window zero left
        window = np.concatenate([head, self._buf[max(0, start) : end]])
        self._consumed += n_chunks * self.chunk
        self._trim()
        return window

    def pop_next_chunk(self) -> np.ndarray:
        """One [left | chunk | right] window; raises when none is ready."""
        if not self.has_chunk:
            raise IndexError("no complete chunk buffered")
        return self._window(1)

    def pop_all_chunks(self) -> np.ndarray:
        """All ready chunk bodies as ONE contiguous
        [left | n*chunk | right] window (empty array when none ready)."""
        n = self.ready_chunks
        if n == 0:
            return np.zeros(0, np.float32)
        return self._window(n)

    def pop_tail(self) -> np.ndarray:
        """Finalization: whatever remains after the last whole chunk,
        with its left context (no zero-padding — the caller pads)."""
        if self.pending <= 0:
            return np.zeros(0, np.float32)
        start = max(0, self._consumed - self.left)
        head = np.zeros(max(0, self.left - self._consumed), np.float32)
        window = np.concatenate([head, self._buf[start:]])
        self._consumed = self._buf.size
        self._trim()
        return window

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)
        self._consumed = 0

    def _trim(self) -> None:
        # keep only what future left contexts can re-read
        keep_from = max(0, self._consumed - self.left)
        if keep_from > 0:
            self._buf = self._buf[keep_from:]
            self._consumed -= keep_from
