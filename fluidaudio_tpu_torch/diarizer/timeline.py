"""DiarizerTimeline: frame-probability accumulator -> finalized/tentative
segments per speaker slot.

Behavioral parity: reference `Diarizer/DiarizerTimeline.swift:9-360` (1391
LoC): accumulate per-frame speaker probabilities from any streaming diarizer;
NeMo-style post-processing (onset/offset hysteresis thresholds, onset/offset
padding, min-duration-on/off); frames older than the lookback horizon become
FINALIZED segments, recent frames stay TENTATIVE (may still change); speaker
slot management (rename/reassign/upsert/remove); emit-only mode returns
segments without mutating state.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from fluidaudio_tpu_torch.diarizer.types import TimedSpeakerSegment


@dataclass(frozen=True)
class TimelineConfig:
    frame_seconds: float = 0.08
    onset_threshold: float = 0.5
    offset_threshold: float = 0.35  # hysteresis: stay active until below this
    onset_padding: float = 0.0
    offset_padding: float = 0.0
    min_duration_on: float = 0.2
    min_duration_off: float = 0.2
    tentative_horizon_seconds: float = 2.0  # recent frames may still change


@dataclass
class _Slot:
    name: str
    probs: list[float] = field(default_factory=list)


class DiarizerTimeline:
    def __init__(self, config: TimelineConfig | None = None):
        self.config = config or TimelineConfig()
        self._slots: dict[int, _Slot] = {}
        self._n_frames = 0

    # ------------------------------------------------------------- ingestion

    def append(self, frame_probs: np.ndarray) -> None:
        """frame_probs [T, S]: per-frame per-slot speech probabilities."""
        probs = np.atleast_2d(np.asarray(frame_probs, np.float32))
        T, S = probs.shape
        for s in range(S):
            slot = self._slots.setdefault(s, _Slot(name=f"spk{s}"))
            # backfill if this slot appeared late
            while len(slot.probs) < self._n_frames:
                slot.probs.append(0.0)
            slot.probs.extend(float(p) for p in probs[:, s])
        self._n_frames += T
        for slot in self._slots.values():
            while len(slot.probs) < self._n_frames:
                slot.probs.append(0.0)

    # ---------------------------------------------------------------- output

    @property
    def duration(self) -> float:
        return self._n_frames * self.config.frame_seconds

    def _binarize(self, probs: np.ndarray) -> np.ndarray:
        """Hysteresis onset/offset binarization (NeMo-style)."""
        cfg = self.config
        active = np.zeros(len(probs), bool)
        on = False
        for i, p in enumerate(probs):
            if not on and p >= cfg.onset_threshold:
                on = True
            elif on and p < cfg.offset_threshold:
                on = False
            active[i] = on
        return active

    def _postprocess(
        self, active: np.ndarray, probs: np.ndarray | None = None
    ) -> list[tuple[float, float, float]]:
        """Spans with confidence = mean probability over the ACTIVE frames
        only — padding frames and bridged-gap frames contribute nothing
        (ref `SortformerTimelineTests.swift:139-199`)."""
        cfg = self.config
        fs = cfg.frame_seconds
        spans: list[list] = []  # [start_s, end_s, active frame indices]
        start = None
        for f in range(len(active) + 1):
            on = f < len(active) and active[f]
            if on and start is None:
                start = f
            elif not on and start is not None:
                spans.append([start * fs - cfg.onset_padding,
                              f * fs + cfg.offset_padding,
                              list(range(start, f))])
                start = None
        # merge gaps shorter than min_duration_off (gap frames NOT counted)
        merged: list[list] = []
        for span in spans:
            if merged and span[0] - merged[-1][1] < cfg.min_duration_off:
                merged[-1][1] = span[1]
                merged[-1][2].extend(span[2])
            else:
                merged.append(span)
        # drop segments shorter than min_duration_on; clamp to [0, duration]
        out = []
        for a, b, frames in merged:
            a, b = max(0.0, a), min(self.duration, b)
            if b - a >= cfg.min_duration_on:
                conf = (
                    float(np.mean(probs[frames])) if probs is not None and frames
                    else 1.0
                )
                out.append((a, b, conf))
        return out

    def segments(
        self, include_tentative: bool = True
    ) -> tuple[list[TimedSpeakerSegment], list[TimedSpeakerSegment]]:
        """Returns (finalized, tentative) segments; emit-only (no state change)."""
        cfg = self.config
        horizon_frames = int(cfg.tentative_horizon_seconds / cfg.frame_seconds)
        final_cut = max(0, self._n_frames - horizon_frames) * cfg.frame_seconds

        finalized: list[TimedSpeakerSegment] = []
        tentative: list[TimedSpeakerSegment] = []
        for slot in self._slots.values():
            probs = np.asarray(slot.probs, np.float32)
            active = self._binarize(probs)
            for a, b, conf in self._postprocess(active, probs):
                if b <= final_cut:
                    finalized.append(TimedSpeakerSegment(slot.name, a, b, conf))
                elif a < final_cut:
                    # straddles the horizon: the finalized part is emitted
                    # REGARDLESS of include_tentative (dropping it hid
                    # already-final speech for any span touching the horizon)
                    finalized.append(
                        TimedSpeakerSegment(slot.name, a, final_cut, conf)
                    )
                    if include_tentative:
                        tentative.append(
                            TimedSpeakerSegment(slot.name, final_cut, b, conf)
                        )
                elif include_tentative:
                    tentative.append(TimedSpeakerSegment(slot.name, a, b, conf))
        finalized.sort(key=lambda s: s.start_time)
        tentative.sort(key=lambda s: s.start_time)
        return finalized, tentative

    def finalize(self) -> list[TimedSpeakerSegment]:
        """Move everything to finalized: emit all segments with no tentative
        horizon (ref `DiarizerTimeline.finalize`,
        `SortformerTimelineTests.swift:113-137`)."""
        out: list[TimedSpeakerSegment] = []
        for slot in self._slots.values():
            probs = np.asarray(slot.probs, np.float32)
            active = self._binarize(probs)
            out.extend(
                TimedSpeakerSegment(slot.name, a, b, conf)
                for a, b, conf in self._postprocess(active, probs)
            )
        out.sort(key=lambda s: s.start_time)
        return out

    # ------------------------------------------------------- slot management

    def rename_slot(self, slot: int, name: str) -> None:
        if slot in self._slots:
            self._slots[slot].name = name

    def slot_names(self) -> dict[int, str]:
        return {s: slot.name for s, slot in self._slots.items()}

    def reassign_slot(self, source: int, target: int) -> None:
        """Merge source slot's activity into target (max-combine), remove source."""
        if source not in self._slots or target not in self._slots:
            return
        src, dst = self._slots[source], self._slots[target]
        n = max(len(src.probs), len(dst.probs))
        merged = [
            max(
                src.probs[i] if i < len(src.probs) else 0.0,
                dst.probs[i] if i < len(dst.probs) else 0.0,
            )
            for i in range(n)
        ]
        dst.probs = merged
        del self._slots[source]

    def remove_slot(self, slot: int) -> None:
        self._slots.pop(slot, None)

    def upsert_slot(self, slot: int, name: str, probs: np.ndarray | None = None) -> None:
        entry = self._slots.setdefault(slot, _Slot(name=name))
        entry.name = name
        if probs is not None:
            entry.probs = [float(p) for p in np.asarray(probs).reshape(-1)]

    def reset(self, keeping_speakers: bool = False) -> None:
        """Clear accumulated frames. With `keeping_speakers`, slot names
        survive (enrollment identity is preserved across resets — ref
        `SortformerDiarizer.swift:287`); otherwise slots are dropped."""
        if keeping_speakers:
            for slot in self._slots.values():
                slot.probs = []
        else:
            self._slots.clear()
        self._n_frames = 0
