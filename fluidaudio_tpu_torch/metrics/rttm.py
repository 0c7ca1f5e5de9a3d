"""RTTM read/write (reference CLI `RTTMParser`, 65 LoC)."""

from __future__ import annotations

from pathlib import Path

from fluidaudio_tpu_torch.diarizer.types import TimedSpeakerSegment


def parse_rttm(path_or_text: str | Path) -> list[TimedSpeakerSegment]:
    if isinstance(path_or_text, Path):
        text = path_or_text.read_text()
    else:
        s = str(path_or_text)
        # a single-line string naming an existing file is treated as a path
        text = Path(s).read_text() if "\n" not in s and Path(s).exists() else s
    segments = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) < 8 or parts[0] != "SPEAKER":
            continue
        start = float(parts[3])
        dur = float(parts[4])
        speaker = parts[7]
        segments.append(TimedSpeakerSegment(speaker_id=speaker, start_time=start,
                                            end_time=start + dur))
    segments.sort(key=lambda s: s.start_time)
    return segments


def write_rttm(segments: list[TimedSpeakerSegment], file_id: str = "file") -> str:
    lines = [
        f"SPEAKER {file_id} 1 {s.start_time:.3f} {s.duration:.3f} <NA> <NA> {s.speaker_id} <NA> <NA>"
        for s in segments
    ]
    return "\n".join(lines) + ("\n" if lines else "")
