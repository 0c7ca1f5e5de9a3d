"""Diarization types.

Behavioral parity: reference `Diarizer/Core/DiarizerTypes.swift:7-107`
(`DiarizerConfig` defaults, `PipelineTimings` incl. bottleneck stage) and
`Clustering/SpeakerTypes.swift` (`Speaker` with EMA main embedding + capped
raw-embedding FIFO).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class DiarizerConfig:
    clustering_threshold: float = 0.7
    min_speech_duration: float = 1.0
    min_embedding_update_duration: float = 2.0
    min_silence_gap: float = 0.5
    num_clusters: int = -1
    min_active_frames_count: float = 10.0
    debug_mode: bool = False
    chunk_duration: float = 10.0
    chunk_overlap: float = 0.0


_SEGMENT_COUNTER = 0


def _next_segment_id() -> int:
    global _SEGMENT_COUNTER
    _SEGMENT_COUNTER += 1
    return _SEGMENT_COUNTER


@dataclass
class RawEmbedding:
    """L2-normalized at construction (ref `SpeakerTypes.swift:214-218`)."""

    embedding: np.ndarray
    timestamp: float = field(default_factory=time.time)
    segment_id: int = field(default_factory=_next_segment_id)

    def __post_init__(self) -> None:
        self.embedding = l2_normalize(np.asarray(self.embedding, np.float32))


MAX_RAW_EMBEDDINGS = 50


def l2_normalize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.float32)
    norm = float(np.linalg.norm(v))
    return v / norm if norm > 0 else v


def cosine_distance(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if na == 0 or nb == 0:
        return 1.0
    return 1.0 - float(np.dot(a, b)) / (na * nb)


@dataclass
class Speaker:
    """Speaker identity record (ref `SpeakerTypes.swift:6-205`).

    The main embedding is L2-normalized at construction; adding/removing a
    raw embedding recalculates it as the L2-normalized average of the raw
    FIFO (ref `recalculateMainEmbedding`, `:131-162`); `update_count` starts
    at 1 and counts embedding updates.
    """

    id: str
    name: str
    current_embedding: np.ndarray
    duration: float = 0.0
    is_permanent: bool = False
    update_count: int = 1
    raw_embeddings: list[RawEmbedding] = field(default_factory=list)
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)

    def __post_init__(self) -> None:
        self.current_embedding = l2_normalize(
            np.asarray(self.current_embedding, np.float32)
        )

    def add_raw_embedding(self, raw: RawEmbedding) -> None:
        if float(np.sum(raw.embedding**2)) <= 0.01:
            return
        if len(self.raw_embeddings) >= MAX_RAW_EMBEDDINGS:
            self.raw_embeddings.pop(0)
        self.raw_embeddings.append(raw)
        self.recalculate_main_embedding()

    def remove_raw_embedding(self, segment_id: int) -> RawEmbedding | None:
        """Remove by segment id and recalc main (ref :120-129)."""
        for i, raw in enumerate(self.raw_embeddings):
            if raw.segment_id == segment_id:
                removed = self.raw_embeddings.pop(i)
                self.recalculate_main_embedding()
                return removed
        return None

    def recalculate_main_embedding(self) -> None:
        """Main embedding := L2-normalized mean of same-size raws (ref :131-162)."""
        if not self.raw_embeddings:
            return
        size = self.raw_embeddings[0].embedding.size
        if size == 0:
            return
        valid = [r.embedding for r in self.raw_embeddings if r.embedding.size == size]
        if not valid:
            return
        self.current_embedding = l2_normalize(np.mean(valid, axis=0))
        self.updated_at = time.time()

    def update_main_embedding(
        self, duration: float, embedding: np.ndarray, alpha: float = 0.9
    ) -> None:
        """EMA blend on top of the raw-average recalc (ref :67-101)."""
        embedding = np.asarray(embedding, np.float32)
        if float(np.sum(np.square(embedding))) <= 0.01:
            return
        norm_emb = l2_normalize(embedding)
        self.add_raw_embedding(RawEmbedding(norm_emb))
        if self.current_embedding.shape == norm_emb.shape:
            self.current_embedding = l2_normalize(
                alpha * self.current_embedding + (1 - alpha) * norm_emb
            )
        self.duration += duration
        self.updated_at = time.time()
        self.update_count += 1

    def merge_with(self, other: "Speaker", keep_name: str | None = None) -> None:
        """Union raws (most-recent 50), recalc main from raws (ref :164-196)."""
        merged = self.raw_embeddings + other.raw_embeddings
        if len(merged) > MAX_RAW_EMBEDDINGS:
            merged = sorted(merged, key=lambda r: r.timestamp, reverse=True)[
                :MAX_RAW_EMBEDDINGS
            ]
        self.raw_embeddings = merged
        self.duration += other.duration
        if keep_name:
            self.name = keep_name
        if self.raw_embeddings:
            self.recalculate_main_embedding()
        else:
            # No raw history on either side: blend mains by duration so the
            # merged identity still reflects both sources.
            total = self.duration
            if total > 0:
                w = other.duration / total
                self.current_embedding = l2_normalize(
                    (1 - w) * self.current_embedding + w * other.current_embedding
                )
        self.updated_at = time.time()
        self.update_count += other.update_count

    # Identity-based equality/hash like the reference (ref :198-204).
    def __eq__(self, other: object) -> bool:
        return isinstance(other, Speaker) and self.id == other.id

    def __hash__(self) -> int:
        return hash(self.id)


@dataclass(frozen=True)
class TimedSpeakerSegment:
    speaker_id: str
    start_time: float
    end_time: float
    quality_score: float = 1.0
    embedding: np.ndarray | None = None

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time


@dataclass
class PipelineTimings:
    segmentation_seconds: float = 0.0
    embedding_seconds: float = 0.0
    clustering_seconds: float = 0.0
    post_processing_seconds: float = 0.0
    total_seconds: float = 0.0

    @property
    def bottleneck_stage(self) -> str:
        stages = {
            "segmentation": self.segmentation_seconds,
            "embedding": self.embedding_seconds,
            "clustering": self.clustering_seconds,
            "post_processing": self.post_processing_seconds,
        }
        return max(stages, key=stages.get)


@dataclass
class DiarizationResult:
    segments: list[TimedSpeakerSegment]
    speaker_count: int
    timings: PipelineTimings = field(default_factory=PipelineTimings)
