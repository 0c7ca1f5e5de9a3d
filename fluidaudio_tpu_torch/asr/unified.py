"""Unified ASR: one FastConformer-RNNT checkpoint for batch AND streaming.

Behavioral parity: reference `Unified/UnifiedAsrManager.swift:5-49` (batch:
15 s full-attention windows merged via ChunkProcessor.mergeChunks) and
`Unified/StreamingUnifiedAsrManager.swift:16` (streaming: STATELESS re-encode
of [left | chunk | right] context windows — no conformer caches; the unified
checkpoint trades cache plumbing for re-compute).

Port of `fluidaudio_tpu/asr/unified.py` over the port's `AsrManager` and
`SlidingWindowAsrManager`. Both facades take `device=`: with no `models`
they load v3 through the port's zoo on that device, the GPU unless
`device="cpu"`. The window bookkeeping (`UnifiedStreamingWindower`,
`UnifiedBatchLayout`) is a copy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fluidaudio_tpu_torch.asr.config import ASRConfig
from fluidaudio_tpu_torch.asr.manager import AsrManager
from fluidaudio_tpu_torch.asr.sliding_window import (
    SlidingWindowAsrConfig,
    SlidingWindowAsrManager,
    SlidingWindowUpdate,
)
from fluidaudio_tpu_torch.models.zoo import AsrModels


@dataclass(frozen=True)
class UnifiedWindowConfig:
    """Streaming window geometry (reference `UnifiedConfig.swift:28-80`):
    [left | chunk | right] encoder frames at 1280 samples/frame."""

    left_frames: int = 70
    chunk_frames: int = 13
    right_frames: int = 13
    sample_rate: int = 16_000
    frame_samples: int = 1_280

    @property
    def window_samples(self) -> int:
        return (self.left_frames + self.chunk_frames + self.right_frames) * self.frame_samples

    @property
    def chunk_samples(self) -> int:
        return self.chunk_frames * self.frame_samples

    @property
    def right_samples(self) -> int:
        return self.right_frames * self.frame_samples

    @property
    def latency_ms(self) -> int:
        return (self.chunk_frames + self.right_frames) * self.frame_samples * 1000 // self.sample_rate

    @property
    def context_suffix(self) -> str:
        """Streaming encoder file-name suffix, e.g. `70_13_13`."""
        return f"{self.left_frames}_{self.chunk_frames}_{self.right_frames}"


@dataclass(frozen=True)
class WindowPlan:
    """One encoder step (reference `UnifiedStreamingWindower.WindowPlan`)."""

    buffer_start: int  # global sample range placed in the encoder window
    buffer_end: int
    buffer_start_frame: int  # global encoder frame of the window start
    holdback_frames: int  # right-context frames withheld (0 on final)


class UnifiedStreamingWindower:
    """Pure window/frame bookkeeping for unified chunked streaming
    (reference `UnifiedStreamingWindower.swift`, mirroring NeMo's
    StreamingBatchedAudioBuffer loop): the first step waits for
    chunk+right samples, later steps for chunk samples; each step encodes
    the trailing `window_samples` and decodes every not-yet-decoded frame
    while holding back the right context. The final flush (holdback 0) is
    emitted at most once — termination never re-derives the encoder's
    length formula."""

    def __init__(self, config: UnifiedWindowConfig | None = None):
        self.config = config or UnifiedWindowConfig()
        self.consumed_samples = 0
        self.decoded_frames = 0
        self.final_flush_emitted = False

    def next_window(self, total_samples: int, is_final: bool) -> WindowPlan | None:
        if self.final_flush_emitted:
            return None
        cfg = self.config
        feed = (
            cfg.chunk_samples + cfg.right_samples
            if self.consumed_samples == 0
            else cfg.chunk_samples
        )
        if self.consumed_samples + feed <= total_samples:
            new_consumed = self.consumed_samples + feed
        elif is_final and total_samples > self.consumed_samples:
            new_consumed = total_samples
        elif is_final and total_samples > 0 and self.consumed_samples == total_samples:
            # stream ended exactly on a chunk boundary: re-encode the final
            # window with holdback 0 so the held-back right context decodes
            new_consumed = total_samples
        else:
            return None

        is_last = is_final and new_consumed >= total_samples
        if is_last:
            self.final_flush_emitted = True
        buffer_start = max(0, new_consumed - cfg.window_samples)
        # frame-align UP so the buffer never exceeds the fixed window
        buffer_start += (-buffer_start) % cfg.frame_samples
        self.consumed_samples = new_consumed
        return WindowPlan(
            buffer_start=buffer_start,
            buffer_end=new_consumed,
            buffer_start_frame=buffer_start // cfg.frame_samples,
            holdback_frames=0 if is_last else cfg.right_frames,
        )

    def decode_range(self, encoder_length: int, plan: WindowPlan) -> range | None:
        """Local encoder-frame range to decode; advances the global decode
        position. None when the window adds nothing new."""
        local_start = self.decoded_frames - plan.buffer_start_frame
        local_end = encoder_length - plan.holdback_frames
        if local_end <= local_start or local_start < 0:
            return None
        self.decoded_frames += local_end - local_start
        return range(local_start, local_end)

    def reset(self) -> None:
        self.consumed_samples = 0
        self.decoded_frames = 0
        self.final_flush_emitted = False


@dataclass(frozen=True)
class UnifiedBatchLayout:
    """Offline 15 s overlapping-window layout
    (reference `UnifiedAsrManager.swift:11-39`)."""

    config: UnifiedWindowConfig = UnifiedWindowConfig()

    @property
    def window_samples(self) -> int:
        return 15 * self.config.sample_rate

    @property
    def chunk_samples(self) -> int:
        fs = self.config.frame_samples
        return self.window_samples // fs * fs

    @property
    def overlap_samples(self) -> int:
        fs = self.config.frame_samples
        requested = 2 * self.config.sample_rate
        return min(requested, self.chunk_samples // 2) // fs * fs

    @property
    def stride_samples(self) -> int:
        return self.chunk_samples - self.overlap_samples

    def chunk_starts(self, total_samples: int) -> list[int]:
        if total_samples <= 0:
            return []
        starts = [0]
        start = self.stride_samples
        while start < total_samples:
            # a window is only needed when it adds samples beyond the last
            if start + self.overlap_samples < total_samples:
                starts.append(start)
            start += self.stride_samples
        return starts


class UnifiedAsrManager:
    """Batch facade: identical to AsrManager but pinned to the unified spec."""

    def __init__(self, models: AsrModels | None = None, config: ASRConfig | None = None,
                 *, device: torch.device | str | None = None):
        """`models=None` loads v3 on `device` (None: the GPU)."""
        self.models = models or AsrModels.load("v3", allow_random_init=True, device=device)
        self._inner = AsrManager(self.models, config)

    def transcribe(self, audio, sample_rate: int | None = None):
        return self._inner.transcribe(audio, sample_rate)


@dataclass(frozen=True)
class UnifiedStreamingConfig:
    chunk_seconds: float = 2.0
    left_context_seconds: float = 10.0
    right_context_seconds: float = 1.0


class StreamingUnifiedAsrManager:
    """Streaming facade: stateless [left|chunk|right] re-encode per step."""

    def __init__(
        self,
        models: AsrModels | None = None,
        config: UnifiedStreamingConfig | None = None,
        *,
        device: torch.device | str | None = None,
    ):
        """`models=None` loads v3 on `device` (None: the GPU)."""
        models = models or AsrModels.load("v3", allow_random_init=True, device=device)
        cfg = config or UnifiedStreamingConfig()
        self._sliding = SlidingWindowAsrManager(
            AsrManager(models),
            SlidingWindowAsrConfig(
                chunk_seconds=cfg.chunk_seconds,
                left_context_seconds=cfg.left_context_seconds,
                right_context_seconds=cfg.right_context_seconds,
            ),
        )

    def make_session(self):
        return self._sliding.make_session()

    def feed(self, samples: np.ndarray, session) -> list[SlidingWindowUpdate]:
        return self._sliding.feed(samples, session)

    def finish(self, session) -> SlidingWindowUpdate:
        return self._sliding.finish(session)

    def consume_token_timings(self, session):
        """Drain per-token timings (absolute seconds) confirmed since the last
        call; bounded buffer for hour-long streams. Reference
        `StreamingUnifiedAsrManager.swift:195-199` (issue #704)."""
        return self._sliding.consume_token_timings(session)

    def consume_word_timings(self, session):
        """Word-level spans since the last drain, for word→speaker
        attribution in streaming diarized ASR. Reference
        `StreamingUnifiedAsrManager.swift:201-209`."""
        return self._sliding.consume_word_timings(session)
