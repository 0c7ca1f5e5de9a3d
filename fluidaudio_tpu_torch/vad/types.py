"""VAD config/state/result types.

Behavioral parity: reference `VAD/VadTypes.swift:4-236` (defaults: threshold
0.85, min speech 0.15 s, min silence 0.75 s, max speech 14 s sized for the 15 s
ASR window, padding 0.1 s, hysteresis negative offset 0.15).

Copy of `fluidaudio_tpu/vad/types.py` (it imports nothing of JAX).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SAMPLE_RATE = 16_000
CHUNK_SIZE = 4096  # 256 ms
CONTEXT_SIZE = 64
STATE_SIZE = 128


@dataclass(frozen=True)
class VadConfig:
    default_threshold: float = 0.85
    debug_mode: bool = False


@dataclass(frozen=True)
class VadSegmentationConfig:
    min_speech_duration: float = 0.15
    min_silence_duration: float = 0.75
    max_speech_duration: float = 14.0
    speech_padding: float = 0.1
    silence_threshold_for_split: float = 0.3
    negative_threshold: float | None = None
    negative_threshold_offset: float = 0.15
    min_silence_at_max_speech: float = 0.098
    use_max_possible_silence_at_max_speech: bool = True

    def __post_init__(self):
        assert self.min_speech_duration >= 0 and self.min_silence_duration >= 0
        assert self.max_speech_duration > 0 and self.speech_padding >= 0
        assert 0 <= self.silence_threshold_for_split <= 1
        if self.negative_threshold is not None:
            assert 0 <= self.negative_threshold <= 1

    def effective_negative_threshold(self, base_threshold: float) -> float:
        if self.negative_threshold is not None:
            return self.negative_threshold
        return max(base_threshold - self.negative_threshold_offset, 0.01)


@dataclass(frozen=True)
class VadState:
    hidden_state: np.ndarray  # [128]
    cell_state: np.ndarray  # [128]
    context: np.ndarray  # [64]

    @classmethod
    def initial(cls) -> "VadState":
        return cls(
            np.zeros(STATE_SIZE, np.float32),
            np.zeros(STATE_SIZE, np.float32),
            np.zeros(CONTEXT_SIZE, np.float32),
        )


@dataclass(frozen=True)
class VadResult:
    probability: float
    is_voice_active: bool
    output_state: VadState
    processing_time: float = 0.0


@dataclass(frozen=True)
class VadSegment:
    start_time: float
    end_time: float

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time

    def start_sample(self, sample_rate: int = SAMPLE_RATE) -> int:
        return int(self.start_time * sample_rate)

    def end_sample(self, sample_rate: int = SAMPLE_RATE) -> int:
        return int(self.end_time * sample_rate)


@dataclass
class VadStreamState:
    model_state: VadState
    triggered: bool = False
    processed_samples: int = 0
    temp_end_sample: int | None = None

    @classmethod
    def initial(cls) -> "VadStreamState":
        return cls(model_state=VadState.initial())


@dataclass(frozen=True)
class VadStreamEvent:
    kind: str  # "speech_start" | "speech_end"
    sample_index: int
    time: float | None = None


@dataclass(frozen=True)
class VadStreamResult:
    state: VadStreamState
    event: VadStreamEvent | None
    probability: float
