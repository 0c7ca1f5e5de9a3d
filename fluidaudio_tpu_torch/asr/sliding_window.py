"""Pseudo-streaming ASR over the offline TDT encoder (two-tier transcript).

Behavioral parity: reference `SlidingWindow/SlidingWindowAsrManager.swift:
10-110,710` + `SlidingWindowAsrSession.swift`: windows of ~15 s assembled as
[left context | chunk | right context] (defaults left 10 s, right 2 s),
re-encoded statelessly; tokens in the chunk region are CONFIRMED, tokens in
the right-context region stay VOLATILE until the next window re-hears them;
per-window errors are absorbed and surfaced at finish
(`SlidingWindowAsrManager.swift:54-57`).

Port of `fluidaudio_tpu/asr/sliding_window.py` over the port's `AsrManager`:
each window is one `manager.transcribe(window, finalize=flush)` on the
models' device. An absorbed window error is counted in
`session.error_count` and logged with its traceback, so a fault inside the
port still shows (the card run asserts the count stays 0).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from fluidaudio_tpu_torch.asr.chunk import TokenWindow
from fluidaudio_tpu_torch.asr.config import TokenTiming, WordTiming, build_word_timings
from fluidaudio_tpu_torch.asr.constants import ASRConstants
from fluidaudio_tpu_torch.asr.manager import AsrManager
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("asr.sliding")


@dataclass(frozen=True)
class SlidingWindowAsrConfig:
    chunk_seconds: float = 3.0  # new audio confirmed per window
    left_context_seconds: float = 10.0
    right_context_seconds: float = 2.0

    @property
    def chunk_samples(self) -> int:
        return int(self.chunk_seconds * ASRConstants.SAMPLE_RATE)

    @property
    def left_samples(self) -> int:
        return int(self.left_context_seconds * ASRConstants.SAMPLE_RATE)

    @property
    def right_samples(self) -> int:
        return int(self.right_context_seconds * ASRConstants.SAMPLE_RATE)

    @property
    def window_samples(self) -> int:
        """Assembled [left | chunk | right] window size."""
        return self.left_samples + self.chunk_samples + self.right_samples

    def validate(self) -> None:
        """The assembled window feeds the fixed 240k-sample (15 s) encoder
        input and must never exceed it (reference issue #686,
        `SlidingWindowAsrManagerTests.swift:50-88`)."""
        if self.chunk_seconds <= 0:
            raise ValueError("chunk_seconds must be positive")
        if self.left_context_seconds < 0 or self.right_context_seconds < 0:
            raise ValueError("context durations must be non-negative")
        if self.window_samples > ASRConstants.MAX_MODEL_SAMPLES:
            raise ValueError(
                f"window {self.window_samples} samples exceeds the model input "
                f"cap {ASRConstants.MAX_MODEL_SAMPLES} "
                f"({self.left_context_seconds}+{self.chunk_seconds}"
                f"+{self.right_context_seconds} s > 15 s)"
            )


@dataclass
class SlidingWindowUpdate:
    confirmed_text: str
    volatile_text: str
    is_final: bool = False


@dataclass
class _Session:
    buffer: np.ndarray
    base: int = 0  # absolute sample index of buffer[0] (history is trimmed)
    consumed: int = 0  # samples whose tokens are confirmed (absolute)
    confirmed: list[TokenWindow] = field(default_factory=list)
    volatile: list[TokenWindow] = field(default_factory=list)
    error_count: int = 0
    # globalized timings of CONFIRMED tokens since the last drain; bounded by
    # consume_token_timings() so hour-long sessions don't grow it (reference
    # `StreamingUnifiedAsrManager.swift:53-59,195-199` pendingTokenTimings)
    pending_timings: list[TokenTiming] = field(default_factory=list)
    volatile_timings: list[TokenTiming] = field(default_factory=list)


class SlidingWindowAsrManager:
    def __init__(self, manager: AsrManager, config: SlidingWindowAsrConfig | None = None):
        self.manager = manager
        self.config = config or SlidingWindowAsrConfig()
        self.config.validate()

    def make_session(self) -> _Session:
        return _Session(buffer=np.zeros(0, np.float32))

    def reset(self, session: _Session) -> None:
        """Discard all buffered audio and transcript state in place."""
        session.buffer = np.zeros(0, np.float32)
        session.base = 0
        session.consumed = 0
        session.confirmed = []
        session.volatile = []
        session.error_count = 0
        session.pending_timings = []
        session.volatile_timings = []

    def feed(self, samples: np.ndarray, session: _Session) -> list[SlidingWindowUpdate]:
        session.buffer = np.concatenate(
            [session.buffer, np.asarray(samples, np.float32).reshape(-1)]
        )
        cfg = self.config
        updates = []
        while (session.base + session.buffer.size - session.consumed
               >= cfg.chunk_samples + cfg.right_samples):
            updates.append(self._process_window(session, flush=False))
        # trim confirmed history past the left context: an unbounded buffer
        # makes hours-long sessions O(total) memory and O(n^2) copies
        keep_from = max(0, session.consumed - cfg.left_samples - session.base)
        if keep_from > 0:
            session.buffer = session.buffer[keep_from:]
            session.base += keep_from
        return updates

    def finish(self, session: _Session) -> SlidingWindowUpdate:
        if session.base + session.buffer.size > session.consumed:
            update = self._process_window(session, flush=True)
        else:
            update = SlidingWindowUpdate(
                self._text(session.confirmed), "", is_final=True
            )
        session.confirmed.extend(session.volatile)
        session.pending_timings.extend(session.volatile_timings)
        session.volatile = []
        session.volatile_timings = []
        return SlidingWindowUpdate(self._text(session.confirmed), "", is_final=True)

    def consume_token_timings(self, session: _Session) -> list[TokenTiming]:
        """Drain the confirmed-token timings accumulated since the last call.

        Times are absolute stream seconds. Draining keeps the buffer bounded
        over hour-long sessions (reference
        `StreamingUnifiedAsrManager.swift:195-199`).
        """
        out = session.pending_timings
        session.pending_timings = []
        return out

    def consume_word_timings(self, session: _Session) -> list[WordTiming]:
        """Word-level timings since the last drain; shares the buffer with
        `consume_token_timings` (call one or the other per cycle). Reference
        `StreamingUnifiedAsrManager.swift:201-209`."""
        return build_word_timings(self.consume_token_timings(session))

    def _process_window(self, session: _Session, flush: bool) -> SlidingWindowUpdate:
        cfg = self.config
        fpe = ASRConstants.SAMPLES_PER_ENCODER_FRAME
        chunk_start = session.consumed
        total = session.base + session.buffer.size
        chunk_end = total if flush else chunk_start + cfg.chunk_samples
        win_start = max(session.base, chunk_start - cfg.left_samples)
        win_end = min(total, chunk_end + cfg.right_samples)
        window = session.buffer[win_start - session.base : win_end - session.base]

        try:
            # only the stream's final window runs the decoder's last-chunk
            # flush (reference `SlidingWindowAsrManager.swift:409`)
            result = self.manager.transcribe(window, finalize=flush)
        except Exception as e:  # absorb per-window failures (reference behavior)
            session.error_count += 1
            logger.warning("sliding window failed (%d so far): %s", session.error_count, e,
                           exc_info=True)
            session.consumed = chunk_end
            return SlidingWindowUpdate(
                self._text(session.confirmed), self._text(session.volatile)
            )

        confirm_limit = (chunk_end - win_start) / ASRConstants.SAMPLE_RATE
        left_skip = (chunk_start - win_start) / ASRConstants.SAMPLE_RATE
        confirmed_new: list[TokenWindow] = []
        volatile_new: list[TokenWindow] = []
        volatile_timings_new: list[TokenTiming] = []
        offset_frames = win_start // fpe
        win_offset_s = win_start / ASRConstants.SAMPLE_RATE
        for t in result.token_timings:
            tw = TokenWindow(
                t.token_id,
                int(t.start_time / ASRConstants.SECONDS_PER_ENCODER_FRAME) + offset_frames,
                t.confidence,
            )
            if t.start_time < left_skip:
                continue  # re-heard left context: already confirmed
            # globalize window-relative times to absolute stream seconds
            gt = TokenTiming(
                t.token, t.token_id,
                win_offset_s + t.start_time, win_offset_s + t.end_time,
                t.confidence,
            )
            if flush or t.start_time < confirm_limit:
                confirmed_new.append(tw)
                session.pending_timings.append(gt)
            else:
                volatile_new.append(tw)
                volatile_timings_new.append(gt)

        session.confirmed.extend(confirmed_new)
        session.volatile = volatile_new
        session.volatile_timings = volatile_timings_new
        session.consumed = chunk_end
        return SlidingWindowUpdate(
            self._text(session.confirmed),
            self._text(session.volatile),
            is_final=flush,
        )

    def _text(self, tokens: list[TokenWindow]) -> str:
        return self.manager.models.tokenizer.decode([t.token for t in tokens])
