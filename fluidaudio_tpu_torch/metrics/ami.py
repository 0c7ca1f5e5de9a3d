"""AMI / Kaldi dataset annotation parsers.

Behavioral parity: reference CLI `AMIParser` (767 LoC) + `AMIKaldiData`
(459 LoC): Kaldi `segments` ("utt spk start end" per line), `text`
("utt word word ..."), speaker maps, and RTTM (see metrics/rttm.py) into
reference transcripts/diarization for benchmark scoring.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from fluidaudio_tpu_torch.diarizer.types import TimedSpeakerSegment


@dataclass(frozen=True)
class KaldiUtterance:
    utt_id: str
    speaker: str
    start: float
    end: float
    text: str = ""


def parse_kaldi_segments(segments_text: str) -> list[KaldiUtterance]:
    """Kaldi segments file: `utt_id recording_or_spk start end` per line."""
    out = []
    for line in segments_text.splitlines():
        parts = line.split()
        if len(parts) < 4:
            continue
        out.append(
            KaldiUtterance(
                utt_id=parts[0], speaker=parts[1],
                start=float(parts[2]), end=float(parts[3]),
            )
        )
    out.sort(key=lambda u: u.start)
    return out


def parse_kaldi_text(text_file: str) -> dict[str, str]:
    """Kaldi text file: `utt_id word word ...` per line."""
    out = {}
    for line in text_file.splitlines():
        parts = line.split(maxsplit=1)
        if len(parts) == 2:
            out[parts[0]] = parts[1].strip()
    return out


def join_segments_and_text(
    segments: list[KaldiUtterance], texts: dict[str, str]
) -> list[KaldiUtterance]:
    return [
        KaldiUtterance(u.utt_id, u.speaker, u.start, u.end, texts.get(u.utt_id, ""))
        for u in segments
    ]


def kaldi_to_reference_transcript(utterances: list[KaldiUtterance]) -> str:
    """Time-ordered reference transcript for WER scoring."""
    return " ".join(u.text for u in utterances if u.text).strip()


def kaldi_to_diarization_reference(
    utterances: list[KaldiUtterance],
) -> list[TimedSpeakerSegment]:
    return [
        TimedSpeakerSegment(speaker_id=u.speaker, start_time=u.start, end_time=u.end)
        for u in utterances
    ]


def ami_speaker_from_utt(utt_id: str) -> str:
    """AMI convention: `AMI_ES2004a_H00_MEE013_...` -> headset/speaker token."""
    parts = utt_id.split("_")
    for p in parts:
        if len(p) == 3 and p[0] == "H" and p[1:].isdigit():
            return p
    return parts[1] if len(parts) > 1 else utt_id
