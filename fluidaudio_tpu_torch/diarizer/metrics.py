"""In-library diarization metrics: DER with Hungarian mapping + collar, JER.

Behavioral parity: reference `Diarizer/DiarizationDER.swift:26-63,238` —
frame-wise DER on a 10 ms grid with optimal (Hungarian) speaker mapping and a
pyannote-style collar around reference segment boundaries. Used as the CI
guardrail metric (reference `offline-pipeline.yml` fails on DER drift).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.optimize import linear_sum_assignment

from fluidaudio_tpu_torch.diarizer.types import TimedSpeakerSegment

FRAME_SECONDS = 0.01  # 10 ms grid


@dataclass(frozen=True)
class DerResult:
    der: float
    miss: float
    false_alarm: float
    confusion: float
    jer: float
    speaker_mapping: dict[str, str]


def _rasterize(
    segments: list[TimedSpeakerSegment], speakers: list[str], n_frames: int
) -> np.ndarray:
    grid = np.zeros((len(speakers), n_frames), dtype=bool)
    index = {s: i for i, s in enumerate(speakers)}
    for seg in segments:
        a = max(0, int(round(seg.start_time / FRAME_SECONDS)))
        b = min(n_frames, int(round(seg.end_time / FRAME_SECONDS)))
        if b > a:
            grid[index[seg.speaker_id], a:b] = True
    return grid


def _collar_mask(reference: list[TimedSpeakerSegment], n_frames: int, collar: float) -> np.ndarray:
    """True = frame is scored (outside the collar around ref boundaries)."""
    scored = np.ones(n_frames, dtype=bool)
    if collar <= 0:
        return scored
    half = collar / 2.0
    for seg in reference:
        for boundary in (seg.start_time, seg.end_time):
            a = max(0, int(round((boundary - half) / FRAME_SECONDS)))
            b = min(n_frames, int(round((boundary + half) / FRAME_SECONDS)))
            scored[a:b] = False
    return scored


def compute_der(
    reference: list[TimedSpeakerSegment],
    hypothesis: list[TimedSpeakerSegment],
    collar: float = 0.25,
    duration: float | None = None,
) -> DerResult:
    if duration is None:
        duration = max(
            [s.end_time for s in reference + hypothesis] or [0.0]
        )
    n_frames = max(1, int(round(duration / FRAME_SECONDS)))

    ref_speakers = sorted({s.speaker_id for s in reference})
    hyp_speakers = sorted({s.speaker_id for s in hypothesis})
    R = _rasterize(reference, ref_speakers, n_frames)  # [Nr, T]
    H = _rasterize(hypothesis, hyp_speakers, n_frames)  # [Nh, T]
    scored = _collar_mask(reference, n_frames, collar)
    R = R[:, scored]
    H = H[:, scored]

    # Hungarian: maximize overlap between ref/hyp speaker pairs
    mapping: dict[str, str] = {}
    if ref_speakers and hyp_speakers:
        overlap = (R[:, None, :] & H[None, :, :]).sum(axis=2)  # [Nr, Nh]
        rows, cols = linear_sum_assignment(-overlap)
        for r, c in zip(rows, cols):
            if overlap[r, c] > 0:
                mapping[hyp_speakers[c]] = ref_speakers[r]

    # remap hypothesis onto reference speaker axes
    H_mapped = np.zeros_like(R)
    ref_index = {s: i for i, s in enumerate(ref_speakers)}
    for j, hs in enumerate(hyp_speakers):
        if hs in mapping:
            H_mapped[ref_index[mapping[hs]]] |= H[j]
        # unmapped hyp speech is already counted via hyp_count (false alarm)

    ref_count = R.sum(axis=0).astype(np.int32)
    hyp_count = H.sum(axis=0).astype(np.int32)
    correct = (R & H_mapped).sum(axis=0).astype(np.int32)

    total_ref = int(ref_count.sum())
    miss = int(np.maximum(ref_count - hyp_count, 0).sum())
    fa = int(np.maximum(hyp_count - ref_count, 0).sum())
    conf = int((np.minimum(ref_count, hyp_count) - np.minimum(correct, np.minimum(ref_count, hyp_count))).sum())

    denom = max(1, total_ref)
    der = (miss + fa + conf) / denom

    # JER: mean per-reference-speaker error rate
    jers = []
    for r, rs in enumerate(ref_speakers):
        ref_r = R[r]
        hyp_r = H_mapped[r]
        union = int((ref_r | hyp_r).sum())
        inter = int((ref_r & hyp_r).sum())
        if union > 0:
            jers.append(1.0 - inter / union)
    jer = float(np.mean(jers)) if jers else 0.0

    return DerResult(
        der=der,
        miss=miss / denom,
        false_alarm=fa / denom,
        confusion=conf / denom,
        jer=jer,
        speaker_mapping=mapping,
    )
