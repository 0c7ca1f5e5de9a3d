"""Silero-style hysteresis speech segmentation (host logic).

Behavioral parity: reference `VAD/VadManager+SpeechSegmentation.swift:12-205`
— per-chunk probability stream -> sample-range segments with: entry threshold
/ negative-threshold hysteresis, min-speech/min-silence gating, max-speech
splitting at the best candidate silence (below-split-threshold longest, else
longest overall), and edge padding with midpoint sharing of short gaps.

Copy of `fluidaudio_tpu/vad/segmentation.py` (it imports nothing of JAX).
"""

from __future__ import annotations

from dataclasses import dataclass

from fluidaudio_tpu_torch.vad.types import (
    CHUNK_SIZE,
    SAMPLE_RATE,
    VadSegment,
    VadSegmentationConfig,
)


@dataclass(frozen=True)
class _CandidateSilence:
    start: int
    duration: int
    min_probability: float


def detect_speech_sample_ranges(
    probabilities: list[float],
    audio_length_samples: int,
    threshold: float,
    config: VadSegmentationConfig,
) -> list[tuple[int, int]]:
    if not probabilities:
        return []

    hop = CHUNK_SIZE
    window = CHUNK_SIZE
    min_speech = int(config.min_speech_duration * SAMPLE_RATE)
    pad = int(config.speech_padding * SAMPLE_RATE)
    if config.max_speech_duration == float("inf"):
        max_speech = None
    else:
        raw = int(config.max_speech_duration * SAMPLE_RATE) - window - 2 * pad
        max_speech = max(0, raw)
    min_silence = int(config.min_silence_duration * SAMPLE_RATE)
    min_silence_at_max = int(config.min_silence_at_max_speech * SAMPLE_RATE)
    negative = config.effective_negative_threshold(threshold)

    triggered = False
    speech_start = 0
    temp_end: int | None = None
    temp_min_prob: float | None = None
    possible_ends: list[_CandidateSilence] = []
    speeches: list[tuple[int, int]] = []

    def flush(end_sample: int) -> None:
        nonlocal speeches
        if end_sample > speech_start and (end_sample - speech_start) >= min_speech:
            speeches.append((speech_start, min(end_sample, audio_length_samples)))

    for index, prob in enumerate(probabilities):
        frame_start = index * hop

        if prob >= threshold:
            if temp_end is not None:
                silence = frame_start - temp_end
                if silence > min_silence_at_max:
                    possible_ends.append(
                        _CandidateSilence(temp_end, silence, temp_min_prob if temp_min_prob is not None else 1.0)
                    )
            temp_end = None
            temp_min_prob = None
            if not triggered:
                triggered = True
                speech_start = frame_start
                continue

        if triggered and max_speech is not None:
            if frame_start - speech_start > max_speech:
                # an ONGOING qualifying silence (temp_end set, speech not yet
                # resumed) is also a split candidate — candidates are normally
                # recorded retroactively at speech resume, which would make a
                # pause still in progress invisible exactly when the cap hits
                candidates = list(possible_ends)
                if temp_end is not None and (frame_start - temp_end) > min_silence_at_max:
                    candidates.append(_CandidateSilence(
                        temp_end, frame_start - temp_end,
                        temp_min_prob if temp_min_prob is not None else 1.0,
                    ))
                chosen: _CandidateSilence | None = None
                if candidates:
                    below = [
                        c for c in candidates
                        if c.min_probability <= config.silence_threshold_for_split
                    ]
                    if below:
                        chosen = max(below, key=lambda c: c.duration)
                    elif config.use_max_possible_silence_at_max_speech:
                        chosen = max(candidates, key=lambda c: c.duration)
                    else:
                        chosen = candidates[-1]

                split_end = chosen.start if chosen else frame_start
                flush(split_end)

                resume_at = None if chosen is None else chosen.start + chosen.duration
                if resume_at is not None and (
                    resume_at < frame_start
                    or (resume_at == frame_start and prob >= threshold)
                ):
                    # resume inside already-seen speech (or exactly at the
                    # current frame when it IS speech — the strict `<` alone
                    # would drop that frame and start the next segment a
                    # hop late)
                    speech_start = resume_at
                    triggered = True
                else:
                    triggered = False

                possible_ends.clear()
                temp_end = None
                temp_min_prob = None
                if not triggered:
                    continue

        if prob < negative and triggered:
            if temp_end is None:
                temp_end = frame_start
            temp_min_prob = prob if temp_min_prob is None else min(temp_min_prob, prob)
            if frame_start - temp_end >= min_silence:
                flush(temp_end)
                triggered = False
                temp_end = None
                temp_min_prob = None
                possible_ends.clear()
                continue

    if triggered:
        flush(audio_length_samples)

    if not speeches:
        return []

    adjusted = [list(s) for s in speeches]
    for i in range(len(adjusted)):
        if i == 0:
            adjusted[i][0] = max(0, adjusted[i][0] - pad)
        if i < len(adjusted) - 1:
            silence = adjusted[i + 1][0] - adjusted[i][1]
            if silence < 2 * pad:
                half = silence // 2
                adjusted[i][1] = min(audio_length_samples, adjusted[i][1] + half)
                adjusted[i + 1][0] = max(0, adjusted[i + 1][0] - half)
            else:
                adjusted[i][1] = min(audio_length_samples, adjusted[i][1] + pad)
                adjusted[i + 1][0] = max(0, adjusted[i + 1][0] - pad)
        else:
            adjusted[i][1] = min(audio_length_samples, adjusted[i][1] + pad)

    out = []
    for start, end in adjusted:
        s = max(0, min(start, audio_length_samples))
        e = max(s, min(end, audio_length_samples))
        if e > s:
            out.append((s, e))
    return out


def segments_from_ranges(ranges: list[tuple[int, int]]) -> list[VadSegment]:
    return [VadSegment(s / SAMPLE_RATE, e / SAMPLE_RATE) for s, e in ranges]
