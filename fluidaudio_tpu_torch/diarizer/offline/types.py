"""Offline diarizer configuration, grouped by stage.

Behavioral parity: reference `Offline/Core/OfflineDiarizerTypes.swift:30-230`
(`OfflineDiarizerConfig` with Segmentation/Embedding/Clustering/VBx/
PostProcessing/Export groups; community default stepRatio 0.1, shipped default
0.2 = 2x faster / -1.2 DER per SURVEY §2.6).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class SegmentationOptions:
    window_seconds: float = 10.0
    step_ratio: float = 0.2  # step = window * ratio
    min_activity_threshold: float = 0.5

    @property
    def samples_per_step(self) -> int:
        """Stride in samples at 16 kHz (`OfflineDiarizerConfig.samplesPerStep`:
        160_000 * 0.2 = 32_000 at the shipped defaults)."""
        return int(self.window_seconds * 16_000 * self.step_ratio)


def total_chunks(sample_count: int, segmentation: "SegmentationOptions") -> int:
    """Segmentation windows needed for `sample_count` samples; at least 1
    (OfflineDiarizerManagerProgressTests:11-27)."""
    step = max(1, segmentation.samples_per_step)
    return max(1, -(-sample_count // step))


@dataclass(frozen=True)
class EmbeddingOptions:
    batch_size: int = 32
    min_active_frames: float = 10.0


@dataclass(frozen=True)
class ClusteringOptions:
    method: str = "ahc_vbx"  # "ahc_vbx" | "ahc" | "kmeans"
    ahc_threshold: float = 0.6  # cosine distance threshold for warm start
    num_speakers: int = -1  # -1 = auto
    min_speakers: int = 1
    max_speakers: int = 20


@dataclass(frozen=True)
class VBxOptions:
    fa: float = 0.07
    fb: float = 0.8
    loop_probability: float = 0.9
    max_iterations: int = 20
    epsilon: float = 1e-4  # ELBO convergence threshold


@dataclass(frozen=True)
class PostProcessingOptions:
    min_duration_on: float = 0.0
    min_duration_off: float = 0.0
    min_gap: float = 0.0


@dataclass(frozen=True)
class OfflineDiarizerConfig:
    segmentation: SegmentationOptions = field(default_factory=SegmentationOptions)
    embedding: EmbeddingOptions = field(default_factory=EmbeddingOptions)
    clustering: ClusteringOptions = field(default_factory=ClusteringOptions)
    vbx: VBxOptions = field(default_factory=VBxOptions)
    post: PostProcessingOptions = field(default_factory=PostProcessingOptions)

    def validate(self) -> None:
        """Raise ValueError on out-of-range stage parameters (reference
        `OfflineDiarizerConfig.validate()`, `OfflineDiarizerTypes.swift` —
        messages name the offending stage.field like the reference's)."""
        if not (0.0 < self.clustering.ahc_threshold <= 1.0):
            raise ValueError(
                f"clustering.threshold must be in (0, 1], got {self.clustering.ahc_threshold}"
            )
        if self.embedding.batch_size < 1:
            raise ValueError(
                f"embedding.batch_size must be >= 1, got {self.embedding.batch_size}"
            )
        if self.post.min_duration_on < 0 or self.post.min_duration_off < 0:
            raise ValueError("post.min_duration_on/off must be >= 0")
        if self.segmentation.window_seconds <= 0:
            raise ValueError(
                f"segmentation.window_seconds must be > 0, got {self.segmentation.window_seconds}"
            )
        if not (0.0 < self.segmentation.step_ratio <= 1.0):
            raise ValueError(
                f"segmentation.step_ratio must be in (0, 1], got {self.segmentation.step_ratio}"
            )
        if self.vbx.max_iterations < 1:
            raise ValueError(
                f"vbx.max_iterations must be >= 1, got {self.vbx.max_iterations}"
            )
        if self.clustering.num_speakers == -1:
            if self.clustering.min_speakers > self.clustering.max_speakers:
                raise ValueError("clustering.min_speakers > max_speakers")
        elif self.clustering.num_speakers < 1:
            raise ValueError(
                f"clustering.num_speakers must be >= 1 (or -1 for auto), got {self.clustering.num_speakers}"
            )

    def with_speakers(
        self,
        min_speakers: int | None = None,
        max_speakers: int | None = None,
        exactly: int | None = None,
    ) -> "OfflineDiarizerConfig":
        """Convenience copy with speaker-count constraints (reference
        `OfflineDiarizerConfig.withSpeakers(min:max:)`/`(exactly:)`).
        `exactly` overrides min/max."""
        import dataclasses

        if exactly is not None:
            clustering = dataclasses.replace(self.clustering, num_speakers=exactly)
        else:
            clustering = dataclasses.replace(
                self.clustering,
                min_speakers=(
                    min_speakers if min_speakers is not None else self.clustering.min_speakers
                ),
                max_speakers=(
                    max_speakers if max_speakers is not None else self.clustering.max_speakers
                ),
            )
        return dataclasses.replace(self, clustering=clustering)


@dataclass(frozen=True)
class SpeakerCountConstraints:
    """Resolved clustering speaker-count bounds
    (reference `SpeakerCountConstraints.swift:6-79`).

    `resolve` clamps everything into [1, num_embeddings]; an exact
    `num_speakers` overrides min/max; min > max silently clamps min down
    (prevents crashes, may not reflect user intent — reference note).
    """

    num_speakers: int | None
    min_speakers: int
    max_speakers: int

    @classmethod
    def resolve(
        cls,
        num_embeddings: int,
        num_speakers: int | None = None,
        min_speakers: int | None = None,
        max_speakers: int | None = None,
    ) -> "SpeakerCountConstraints":
        resolved_min = num_speakers if num_speakers is not None else (
            min_speakers if min_speakers is not None else 1
        )
        resolved_min = max(1, min(num_embeddings, resolved_min))

        resolved_max = num_speakers if num_speakers is not None else (
            max_speakers if max_speakers is not None else num_embeddings
        )
        resolved_max = max(1, min(num_embeddings, resolved_max))

        if resolved_min > resolved_max:
            resolved_min = resolved_max

        resolved_num = resolved_min if resolved_min == resolved_max else num_speakers
        return cls(
            num_speakers=resolved_num,
            min_speakers=resolved_min,
            max_speakers=resolved_max,
        )

    def needs_adjustment(self, detected_count: int) -> bool:
        return detected_count < self.min_speakers or detected_count > self.max_speakers

    def target_count(self, detected_count: int) -> int:
        if detected_count < self.min_speakers:
            return self.min_speakers
        if detected_count > self.max_speakers:
            return self.max_speakers
        return detected_count
