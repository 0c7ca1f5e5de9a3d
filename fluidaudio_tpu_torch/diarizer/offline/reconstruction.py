"""Frames -> final speaker segments.

Behavioral parity: reference `Offline/Clustering/OfflineReconstruction` (430
LoC): aggregate per-window speaker activity under the global cluster labels,
resolve overlapping windows by averaging, binarize, then build segments with
min-gap/min-duration post-processing and "S1..." speaker ids.
"""

from __future__ import annotations

import numpy as np

from fluidaudio_tpu_torch.diarizer.offline.segmentation import SegmentationChunk
from fluidaudio_tpu_torch.diarizer.offline.types import PostProcessingOptions
from fluidaudio_tpu_torch.diarizer.types import TimedSpeakerSegment
from fluidaudio_tpu_torch.models.pyannote_seg import NUM_FRAMES

FRAME_STEP = 10.0 / NUM_FRAMES  # seconds per segmentation frame within a window


def reconstruct_segments(
    chunks: list[SegmentationChunk],
    emb_index: list[tuple[int, int]],
    labels: np.ndarray,
    total_seconds: float,
    options: PostProcessingOptions,
    activation_threshold: float = 0.5,
) -> list[TimedSpeakerSegment]:
    if not chunks or labels.size == 0:
        return []
    n_clusters = int(labels.max()) + 1
    grid = int(np.ceil(total_seconds / FRAME_STEP)) + 1
    accum = np.zeros((n_clusters, grid), np.float64)
    counts = np.zeros(grid, np.float64)

    cluster_of: dict[tuple[int, int], int] = {
        (ci, s): int(labels[m]) for m, (ci, s) in enumerate(emb_index)
    }

    for ci, chunk in enumerate(chunks):
        base = int(round(chunk.start_seconds / FRAME_STEP))
        end = min(grid, base + chunk.weights.shape[0])
        span = end - base
        if span <= 0:
            continue
        counts[base:end] += 1.0
        for s in range(chunk.weights.shape[1]):
            cluster = cluster_of.get((ci, s))
            if cluster is None:
                continue
            accum[cluster, base:end] += chunk.weights[:span, s]

    counts = np.maximum(counts, 1.0)
    activity = accum / counts[None, :]  # [K, grid]

    segments: list[TimedSpeakerSegment] = []
    for k in range(n_clusters):
        active = activity[k] >= activation_threshold
        # min-gap fill
        if options.min_gap > 0:
            gap_frames = int(round(options.min_gap / FRAME_STEP))
            active = _fill_gaps(active, gap_frames)
        start = None
        for f in range(grid + 1):
            on = f < grid and active[f]
            if on and start is None:
                start = f
            elif not on and start is not None:
                a, b = start * FRAME_STEP, f * FRAME_STEP
                if b - a >= options.min_duration_on:
                    segments.append(
                        TimedSpeakerSegment(
                            speaker_id=f"S{k + 1}",
                            start_time=a,
                            end_time=min(b, total_seconds),
                        )
                    )
                start = None
    segments.sort(key=lambda s: s.start_time)
    return segments


def _fill_gaps(active: np.ndarray, max_gap: int) -> np.ndarray:
    if max_gap <= 0:
        return active
    out = active.copy()
    idx = np.where(active)[0]
    for a, b in zip(idx, idx[1:]):
        if 1 < b - a <= max_gap + 1:
            out[a:b] = True
    return out
