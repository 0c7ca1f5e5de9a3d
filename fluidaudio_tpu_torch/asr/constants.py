"""Frame/rate constants shared across the ASR stack.

Behavioral parity: reference `Shared/ASRConstants.swift:4-69`.
"""

from __future__ import annotations

import math


class ASRConstants:
    SAMPLE_RATE: int = 16_000
    # Encoder windows are capped at 15 s (240k samples) like the reference's
    # CoreML encoder (`ASRConstants.maxModelSamples`). Here this is a
    # batching choice, not a hardware limit; windows stack on the batch axis.
    MAX_MODEL_SAMPLES: int = 240_000
    MEL_HOP_SIZE: int = 160
    ENCODER_SUBSAMPLING: int = 8
    SAMPLES_PER_ENCODER_FRAME: int = MEL_HOP_SIZE * ENCODER_SUBSAMPLING  # 1280 = 80 ms
    SECONDS_PER_ENCODER_FRAME: float = SAMPLES_PER_ENCODER_FRAME / SAMPLE_RATE  # 0.08
    SENTENCEPIECE_WORD_BOUNDARY: str = "▁"  # ▁
    # period / comma / question-mark token IDs in the parakeet-tdt vocab
    # (reference `ASRConstants.punctuationTokens`, used by boundary dedup)
    PUNCTUATION_TOKENS: frozenset[int] = frozenset((7883, 7952, 7948))
    MINIMUM_AUDIO_DURATION_SECONDS: float = 0.1

    @staticmethod
    def encoder_frames(samples: int) -> int:
        return math.ceil(samples / ASRConstants.SAMPLES_PER_ENCODER_FRAME)

    @staticmethod
    def minimum_required_samples(sample_rate: int = SAMPLE_RATE) -> int:
        return int(sample_rate * ASRConstants.MINIMUM_AUDIO_DURATION_SECONDS)
