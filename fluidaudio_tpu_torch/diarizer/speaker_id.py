"""Speaker embedding extraction + cosine verification/identification.

Behavioral parity: reference `Clustering/SpeakerOperations.swift:62-390`
(cosine distance / validation / raw-embedding merge math) and the speaker-id
CLI flow (BASELINE config #2: embedding extraction + cosine verification).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from fluidaudio_tpu_torch.diarizer.types import cosine_distance, l2_normalize
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("diarizer.speaker_id")


@dataclass(frozen=True)
class VerificationResult:
    is_match: bool
    similarity: float  # cosine similarity in [-1, 1]
    threshold: float


@dataclass(frozen=True)
class IdentificationResult:
    speaker_id: str | None
    similarity: float
    all_scores: dict[str, float]


class SpeakerVerifier:
    """Cosine-similarity speaker verification over enrolled profiles."""

    def __init__(self, embedder=None, threshold: float = 0.35, *, device=None):
        """`embedder`: callable samples -> 256-d embedding; defaults to the
        online diarizer's extractor (built lazily, on `device`: None is the
        GPU, "cpu" the CPU)."""
        self._embedder = embedder
        self._device = device
        self.threshold = threshold
        self.profiles: dict[str, np.ndarray] = {}

    def _embed(self, samples: np.ndarray) -> np.ndarray:
        if self._embedder is None:
            from fluidaudio_tpu_torch.diarizer.manager import DiarizerManager

            manager = DiarizerManager(device=self._device)
            self._embedder = manager.extract_speaker_embedding
        return l2_normalize(np.asarray(self._embedder(samples), np.float32))

    # ------------------------------------------------------------- enrollment

    def enroll(self, speaker_id: str, samples: np.ndarray) -> None:
        emb = self._embed(samples)
        if speaker_id in self.profiles:
            # average with the existing profile (raw-embedding merge)
            self.profiles[speaker_id] = l2_normalize(
                0.5 * self.profiles[speaker_id] + 0.5 * emb
            )
        else:
            self.profiles[speaker_id] = emb

    def enroll_embedding(self, speaker_id: str, embedding: np.ndarray) -> None:
        self.profiles[speaker_id] = l2_normalize(embedding)

    # ------------------------------------------------------------ verification

    def verify(self, speaker_id: str, samples: np.ndarray) -> VerificationResult:
        if speaker_id not in self.profiles:
            raise KeyError(f"speaker {speaker_id!r} not enrolled")
        emb = self._embed(samples)
        sim = 1.0 - cosine_distance(emb, self.profiles[speaker_id])
        return VerificationResult(sim >= self.threshold, sim, self.threshold)

    def identify(self, samples: np.ndarray) -> IdentificationResult:
        if not self.profiles:
            return IdentificationResult(None, -1.0, {})
        emb = self._embed(samples)
        scores = {
            sid: 1.0 - cosine_distance(emb, profile)
            for sid, profile in self.profiles.items()
        }
        best = max(scores, key=scores.get)
        if scores[best] >= self.threshold:
            return IdentificationResult(best, scores[best], scores)
        return IdentificationResult(None, scores[best], scores)

    # -------------------------------------------------------------- persistence

    def save(self, path: str | Path) -> None:
        np.savez(path, **self.profiles)

    def load(self, path: str | Path) -> None:
        data = np.load(path)
        self.profiles.update({k: data[k] for k in data.files})
