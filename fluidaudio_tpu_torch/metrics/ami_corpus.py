"""AMI NXT annotation corpus: XML parsers, ground-truth loaders, Kaldi splits.

Behavioral parity with the reference CLI's AMI toolchain:
- `AMIParser.swift` (767 LoC): NXT `segments`/`words` XML parsing, the
  meetings.xml A-D -> participant mapping, short-segment filtering, word
  merging, and Kaldi-style 10 ms frame-quantized DER references.
- `AMIKaldiData.swift` (459 LoC): Kaldi split construction (`wav.scp`,
  `segments`, `utt2spk`, `spk2utt`, `reco2dur`, `reco2num_spk`,
  `utt2timestamp`) and the split-backed DER reference loader.
- `DiarizationBenchmarkUtils.swift:56-163`: split meeting lists and RTTM
  lookup order; `DatasetDownloader.swift:266-364`: forced-alignment RTTM
  staging.

This module is pure-host dataset plumbing (no device code): it feeds the
diarization benchmark harnesses in `cli/benchmarks.py`.
"""

from __future__ import annotations

import math
import shutil
import xml.etree.ElementTree as ET
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from fluidaudio_tpu_torch.diarizer.types import TimedSpeakerSegment
from fluidaudio_tpu_torch.utils.audio_io import read_wav_raw

AMI_SPEAKER_CODES = ("A", "B", "C", "D")
DEFAULT_MERGE_GAP_SECONDS = 0.5  # AMIParser.swift:8
DEFAULT_REFERENCE_FRAME_STEP = 0.01  # AMIParser.swift:9
SHORT_SEGMENT_SECONDS = 0.5  # AMIParser.swift:131-133
KALDI_FRAME_STEP = 80.0 / 8000.0  # AMIKaldiData.swift:11-13
REQUIRED_KALDI_FILES = (
    "wav.scp",
    "segments",
    "utt2spk",
    "spk2utt",
    "reco2dur",
    "reco2num_spk",
    "utt2timestamp",
)

# DiarizationBenchmarkUtils.getAMIMeetings — dev/test splits (train omitted
# from the default benchmark path but available for Kaldi split builds).
AMI_TEST_MEETINGS = (
    "EN2002a", "EN2002b", "EN2002c", "EN2002d",
    "ES2004a", "ES2004b", "ES2004c", "ES2004d",
    "IS1009a", "IS1009b", "IS1009c", "IS1009d",
    "TS3003a", "TS3003b", "TS3003c", "TS3003d",
)
AMI_DEV_MEETINGS = (
    "ES2011a", "ES2011b", "ES2011c", "ES2011d",
    "IB4001", "IB4002", "IB4003", "IB4004", "IB4010", "IB4011",
    "IS1008a", "IS1008b", "IS1008c", "IS1008d",
    "TS3004a", "TS3004b", "TS3004c", "TS3004d",
)


class AmiDataError(RuntimeError):
    """Invalid/missing AMI annotation or Kaldi split data."""


@dataclass(frozen=True)
class AmiSpeakerSegment:
    """One NXT annotation interval (AMIParser.swift:500-510)."""

    segment_id: str
    participant_id: str  # speaker code at parse time, global name after mapping
    start_time: float
    end_time: float

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time


@dataclass(frozen=True)
class AmiSpeakerMapping:
    """meetings.xml nxt_agent (A-D) -> global participant id (AMIParser.swift:512-528)."""

    meeting_id: str
    speakers: dict[str, str]

    def participant_id(self, speaker_code: str) -> str | None:
        return self.speakers.get(speaker_code.upper())


# --------------------------------------------------------------------- XML


def _local_tag(tag: str) -> str:
    """Strip `{namespace}` / `prefix:` from an element or attribute name."""
    if "}" in tag:
        return tag.rsplit("}", 1)[-1]
    return tag.rsplit(":", 1)[-1]


def _attrs(elem: ET.Element) -> dict[str, str]:
    return {_local_tag(k): v for k, v in elem.attrib.items()}


def _speaker_code_from_filename(filename: str) -> str:
    """`ES2004a.A.segments.xml` -> `A` (AMIParser.swift:588-596)."""
    parts = filename.split(".")
    return parts[1] if len(parts) >= 3 else "UNKNOWN"


def parse_segments_file(path: str | Path) -> list[AmiSpeakerSegment]:
    """Parse a NXT `{meeting}.{code}.segments.xml` file.

    Keeps every `<segment>` with valid `transcriber_start`/`transcriber_end`
    (AMIParser.swift:667-701); invalid entries are skipped, not fatal.
    """
    path = Path(path)
    code = _speaker_code_from_filename(path.name)
    try:
        root = ET.parse(path).getroot()
    except ET.ParseError as e:
        raise AmiDataError(f"failed to parse XML file: {path.name}: {e}") from e

    out: list[AmiSpeakerSegment] = []
    for elem in root.iter():
        if _local_tag(elem.tag) != "segment":
            continue
        a = _attrs(elem)
        try:
            start = float(a["transcriber_start"])
            end = float(a["transcriber_end"])
        except (KeyError, ValueError):
            continue
        out.append(
            AmiSpeakerSegment(
                segment_id=a.get("id", ""),
                participant_id=code,
                start_time=start,
                end_time=end,
            )
        )
    return out


def parse_words_file(path: str | Path) -> list[AmiSpeakerSegment]:
    """Parse a forced-alignment `{meeting}.{code}.words.xml` file.

    `<w>` elements only; punctuation (`punc="true"`) and zero/negative
    durations are dropped (AMIParser.swift:622-660). `<pause>`/`<vocalsound>`
    elements are ignored.
    """
    path = Path(path)
    code = _speaker_code_from_filename(path.name)
    try:
        root = ET.parse(path).getroot()
    except ET.ParseError as e:
        raise AmiDataError(f"failed to parse XML file: {path.name}: {e}") from e

    out: list[AmiSpeakerSegment] = []
    for elem in root.iter():
        if _local_tag(elem.tag) != "w":
            continue
        a = _attrs(elem)
        if a.get("punc") == "true":
            continue
        try:
            start = float(a["starttime"])
            end = float(a["endtime"])
        except (KeyError, ValueError):
            continue
        if end <= start:
            continue
        out.append(
            AmiSpeakerSegment(
                segment_id=a.get("id", ""),
                participant_id=code,
                start_time=start,
                end_time=end,
            )
        )
    return out


def parse_speaker_mapping(
    meeting_id: str, meetings_file: str | Path
) -> AmiSpeakerMapping | None:
    """Parse meetings.xml for one meeting's A-D -> global_name mapping
    (AMIParser.swift:598-621, 705-760)."""
    try:
        root = ET.parse(meetings_file).getroot()
    except ET.ParseError as e:
        raise AmiDataError(f"failed to parse meetings.xml: {e}") from e

    for meeting in root.iter():
        if _local_tag(meeting.tag) != "meeting":
            continue
        if meeting.attrib.get("observation") != meeting_id:
            continue
        speakers: dict[str, str] = {}
        for sp in meeting.iter():
            if _local_tag(sp.tag) != "speaker":
                continue
            agent = sp.attrib.get("nxt_agent")
            name = sp.attrib.get("global_name")
            if agent and name:
                speakers[agent] = name
        return AmiSpeakerMapping(meeting_id=meeting_id, speakers=speakers)
    return None


def ground_truth_speaker_count(meeting_id: str, annotations_root: str | Path) -> int:
    """Speaker count from meetings.xml; AMI default 4 when unknown
    (AMIParser.swift:12-41)."""
    meetings_file = Path(annotations_root) / "corpusResources" / "meetings.xml"
    if meetings_file.exists():
        try:
            mapping = parse_speaker_mapping(meeting_id, meetings_file)
        except AmiDataError:
            mapping = None
        if mapping is not None and mapping.speakers:
            return len(mapping.speakers)
    return 4


# ------------------------------------------------------------ ground truth


def _placeholder_embedding(participant_id: str) -> np.ndarray:
    """Deterministic per-participant pseudo-embedding (AMIParser.swift:362-373;
    crc32 replaces Swift's process-seeded hashValue so runs reproduce)."""
    seed = zlib.crc32(participant_id.encode()) % 1000
    i = np.arange(512, dtype=np.float64)
    return (np.sin(seed + i * 37.0) * 0.5 + 0.5).astype(np.float32)


def _merge_word_segments(
    segments: list[AmiSpeakerSegment], merge_gap: float
) -> list[AmiSpeakerSegment]:
    """Merge adjacent same-speaker words with gaps <= merge_gap
    (AMIParser.swift:405-429)."""
    ordered = sorted(segments, key=lambda s: s.start_time)
    if not ordered:
        return []
    merged: list[AmiSpeakerSegment] = []
    current = ordered[0]
    for nxt in ordered[1:]:
        if nxt.start_time - current.end_time <= merge_gap:
            current = AmiSpeakerSegment(
                segment_id=current.segment_id,
                participant_id=current.participant_id,
                start_time=current.start_time,
                end_time=max(current.end_time, nxt.end_time),
            )
            continue
        merged.append(current)
        current = nxt
    merged.append(current)
    return merged


def load_official_ground_truth(
    meeting_id: str,
    annotations_root: str | Path,
    *,
    filter_short_segments: bool = True,
) -> list[TimedSpeakerSegment]:
    """Official NXT segments ground truth (AMIParser.swift:95-160): per-speaker
    `segments/` XML mapped through meetings.xml; segments shorter than 0.5 s
    are dropped when `filter_short_segments`."""
    root = Path(annotations_root)
    meetings_file = root / "corpusResources" / "meetings.xml"
    mapping = parse_speaker_mapping(meeting_id, meetings_file)
    if mapping is None:
        raise AmiDataError(f"no speaker mapping found for {meeting_id}")

    out: list[TimedSpeakerSegment] = []
    for code in AMI_SPEAKER_CODES:
        seg_file = root / "segments" / f"{meeting_id}.{code}.segments.xml"
        if not seg_file.exists():
            continue
        participant = mapping.participant_id(code)
        if participant is None:
            continue
        for seg in parse_segments_file(seg_file):
            if seg.duration <= 0:
                continue
            if filter_short_segments and seg.duration < SHORT_SEGMENT_SECONDS:
                continue
            out.append(
                TimedSpeakerSegment(
                    speaker_id=participant,
                    start_time=seg.start_time,
                    end_time=seg.end_time,
                    quality_score=1.0,
                    embedding=_placeholder_embedding(participant),
                )
            )

    out.sort(key=lambda s: (s.start_time, s.end_time, s.speaker_id))
    return out


def load_ami_ground_truth(
    meeting_id: str, annotations_root: str | Path
) -> list[TimedSpeakerSegment]:
    """Legacy official ground truth with short-segment filtering
    (AMIParser.swift:82-93)."""
    return load_official_ground_truth(
        meeting_id, annotations_root, filter_short_segments=True
    )


def load_word_aligned_ground_truth(
    meeting_id: str,
    annotations_root: str | Path,
    *,
    merge_gap: float = DEFAULT_MERGE_GAP_SECONDS,
) -> list[TimedSpeakerSegment]:
    """Word-aligned ground truth from forced-alignment `words/` XML, merging
    adjacent same-speaker words with gaps <= merge_gap (AMIParser.swift:246-291)."""
    root = Path(annotations_root)
    meetings_file = root / "corpusResources" / "meetings.xml"
    mapping = parse_speaker_mapping(meeting_id, meetings_file)
    if mapping is None:
        raise AmiDataError(f"no speaker mapping found for {meeting_id}")

    out: list[TimedSpeakerSegment] = []
    for code in AMI_SPEAKER_CODES:
        words_file = root / "words" / f"{meeting_id}.{code}.words.xml"
        if not words_file.exists():
            continue
        participant = mapping.participant_id(code)
        if participant is None:
            continue
        for seg in _merge_word_segments(parse_words_file(words_file), merge_gap):
            out.append(
                TimedSpeakerSegment(
                    speaker_id=participant,
                    start_time=seg.start_time,
                    end_time=seg.end_time,
                    quality_score=1.0,
                    embedding=_placeholder_embedding(participant),
                )
            )

    out.sort(key=lambda s: s.start_time)
    return out


def load_word_aligned_der_reference(
    meeting_id: str,
    annotations_root: str | Path,
    *,
    merge_gap: float = DEFAULT_MERGE_GAP_SECONDS,
) -> list[TimedSpeakerSegment]:
    """Word-aligned DER reference (AMIParser.swift:312-332): same segments as
    the ground truth, embeddings not needed for scoring."""
    return load_word_aligned_ground_truth(
        meeting_id, annotations_root, merge_gap=merge_gap
    )


def _round_half_even(value: float) -> int:
    """Swift `.rounded(.toNearestOrEven)` — Python round() is banker's too,
    but guard against float repr drift near .5 boundaries."""
    nearest = math.floor(value + 0.5)
    if abs(value - (math.floor(value) + 0.5)) < 1e-9:
        floor = math.floor(value)
        return int(floor if floor % 2 == 0 else floor + 1)
    return int(nearest)


def frame_aligned_der_reference(
    segments: list[TimedSpeakerSegment],
    *,
    frame_step: float = DEFAULT_REFERENCE_FRAME_STEP,
) -> list[TimedSpeakerSegment]:
    """Quantize segments to Kaldi-style frames and merge per-speaker
    overlapping/adjacent intervals (AMIParser.swift:431-497): matches the
    label construction of the LS-EEND repo's original recipe."""
    if frame_step <= 0:
        raise ValueError("frame_step must be positive")

    by_speaker: dict[str, list[tuple[int, int]]] = {}
    for seg in segments:
        start_f = _round_half_even(seg.start_time / frame_step)
        end_f = _round_half_even(seg.end_time / frame_step)
        if end_f <= start_f:
            continue
        by_speaker.setdefault(seg.speaker_id, []).append((start_f, end_f))

    out: list[TimedSpeakerSegment] = []
    for speaker, intervals in by_speaker.items():
        intervals.sort()
        cur_start, cur_end = intervals[0]
        for nxt_start, nxt_end in intervals[1:]:
            if nxt_start <= cur_end:
                cur_end = max(cur_end, nxt_end)
                continue
            out.append(
                TimedSpeakerSegment(
                    speaker_id=speaker,
                    start_time=cur_start * frame_step,
                    end_time=cur_end * frame_step,
                )
            )
            cur_start, cur_end = nxt_start, nxt_end
        out.append(
            TimedSpeakerSegment(
                speaker_id=speaker,
                start_time=cur_start * frame_step,
                end_time=cur_end * frame_step,
            )
        )

    out.sort(key=lambda s: (s.start_time, s.end_time, s.speaker_id))
    return out


def load_frame_aligned_der_reference(
    meeting_id: str,
    annotations_root: str | Path,
    *,
    frame_step: float = DEFAULT_REFERENCE_FRAME_STEP,
) -> list[TimedSpeakerSegment]:
    """Unfiltered official segments, 10 ms frame-quantized
    (AMIParser.swift:197-214)."""
    segments = load_official_ground_truth(
        meeting_id, annotations_root, filter_short_segments=False
    )
    return frame_aligned_der_reference(segments, frame_step=frame_step)


def generate_simplified_ground_truth(
    duration: float, speaker_count: int
) -> list[TimedSpeakerSegment]:
    """Round-robin placeholder ground truth when annotations are absent
    (AMIParser.swift:334-360)."""
    seg_dur = duration / float(speaker_count * 2)
    dummy = np.full(512, 0.1, dtype=np.float32)
    out = []
    for i in range(speaker_count * 2):
        start = i * seg_dur
        out.append(
            TimedSpeakerSegment(
                speaker_id=f"Speaker {(i % speaker_count) + 1}",
                start_time=start,
                end_time=min(start + seg_dur, duration),
                quality_score=1.0,
                embedding=dummy,
            )
        )
    return out


# ------------------------------------------------------------ Kaldi splits


@dataclass(frozen=True)
class KaldiSegmentEntry:
    """One line of a Kaldi `segments` file (AMIKaldiData.swift:15-21)."""

    utterance_id: str
    recording_id: str
    speaker_id: str
    start_time: float
    end_time: float


def _fmt_seconds(value: float) -> str:
    return f"{value:.6f}"  # AMIKaldiData.swift formatSeconds


def _utterance_id(meeting_id: str, speaker_code: str, ordinal: int) -> str:
    return f"{meeting_id}_{speaker_code.lower()}_{ordinal:05d}"


def _audio_duration_seconds(path: Path) -> float:
    samples, rate = read_wav_raw(path)
    return samples.shape[0] / float(rate)


def kaldi_split_exists(split_dir: str | Path) -> bool:
    split_dir = Path(split_dir)
    return all((split_dir / name).exists() for name in REQUIRED_KALDI_FILES)


def build_kaldi_split(
    meeting_ids: list[str] | tuple[str, ...],
    annotations_root: str | Path,
    audio_root: str | Path,
    output_dir: str | Path,
) -> None:
    """Write the 7 Kaldi data files for the given meetings
    (AMIKaldiData.swift:108-199). Meetings missing audio, speaker mapping, or
    segments are skipped; raises when nothing could be built."""
    annotations_root = Path(annotations_root)
    audio_root = Path(audio_root)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    meetings_file = annotations_root / "corpusResources" / "meetings.xml"
    segments_dir = annotations_root / "segments"

    wav_lines: list[str] = []
    segment_lines: list[str] = []
    utt2spk_lines: list[str] = []
    utt2ts_lines: list[str] = []
    reco2dur_lines: list[str] = []
    reco2num_lines: list[str] = []
    spk_to_utts: dict[str, list[str]] = {}
    built = 0

    for meeting_id in sorted(meeting_ids):
        audio_path = audio_root / f"{meeting_id}.Mix-Headset.wav"
        if not audio_path.exists():
            continue
        mapping = parse_speaker_mapping(meeting_id, meetings_file)
        if mapping is None:
            continue

        entries: list[KaldiSegmentEntry] = []
        for code in AMI_SPEAKER_CODES:
            seg_file = segments_dir / f"{meeting_id}.{code}.segments.xml"
            if not seg_file.exists():
                continue
            participant = mapping.participant_id(code)
            if participant is None:
                continue
            ordinal = 0
            for seg in parse_segments_file(seg_file):
                ordinal += 1
                if seg.duration <= 0:
                    continue
                entries.append(
                    KaldiSegmentEntry(
                        utterance_id=_utterance_id(meeting_id, code, ordinal),
                        recording_id=meeting_id,
                        speaker_id=participant,
                        start_time=seg.start_time,
                        end_time=seg.end_time,
                    )
                )
        if not entries:
            continue

        entries.sort(
            key=lambda e: (e.recording_id, e.start_time, e.end_time, e.utterance_id)
        )
        duration = _audio_duration_seconds(audio_path)
        speakers = sorted({e.speaker_id for e in entries})

        wav_lines.append(f"{meeting_id} {audio_path}")
        reco2dur_lines.append(f"{meeting_id} {_fmt_seconds(duration)}")
        reco2num_lines.append(f"{meeting_id} {len(speakers)}")
        for e in entries:
            segment_lines.append(
                f"{e.utterance_id} {e.recording_id} "
                f"{_fmt_seconds(e.start_time)} {_fmt_seconds(e.end_time)}"
            )
            utt2spk_lines.append(f"{e.utterance_id} {e.speaker_id}")
            utt2ts_lines.append(
                f"{e.utterance_id} {_fmt_seconds(e.start_time)} {_fmt_seconds(e.end_time)}"
            )
            spk_to_utts.setdefault(e.speaker_id, []).append(e.utterance_id)
        built += 1

    if built == 0:
        raise AmiDataError(
            "Failed to build AMI Kaldi data: no meetings had both audio and annotations."
        )

    spk2utt_lines = [
        " ".join([spk] + sorted(utts)) for spk, utts in sorted(spk_to_utts.items())
    ]

    def write(lines: list[str], name: str) -> None:
        (output_dir / name).write_text("\n".join(lines) + "\n")

    write(sorted(wav_lines), "wav.scp")
    write(sorted(segment_lines), "segments")
    write(sorted(utt2spk_lines), "utt2spk")
    write(spk2utt_lines, "spk2utt")
    write(sorted(reco2dur_lines), "reco2dur")
    write(sorted(reco2num_lines), "reco2num_spk")
    write(sorted(utt2ts_lines), "utt2timestamp")


def _parse_key_value_file(path: Path) -> dict[str, str]:
    out: dict[str, str] = {}
    for line in path.read_text().splitlines():
        if not line.strip():
            continue
        parts = line.split(maxsplit=1)
        if len(parts) != 2:
            raise AmiDataError(f"Invalid key-value line in {path.name}: {line}")
        out[parts[0]] = parts[1]
    return out


def recording_ids(split_dir: str | Path, max_files: int | None = None) -> list[str]:
    ids = sorted(_parse_key_value_file(Path(split_dir) / "wav.scp").keys())
    return ids[:max_files] if max_files is not None else ids


def audio_path(meeting_id: str, split_dir: str | Path) -> str | None:
    return _parse_key_value_file(Path(split_dir) / "wav.scp").get(meeting_id)


def recording_duration(meeting_id: str, split_dir: str | Path) -> float | None:
    value = _parse_key_value_file(Path(split_dir) / "reco2dur").get(meeting_id)
    return float(value) if value is not None else None


def _segment_entries(split_dir: Path) -> list[KaldiSegmentEntry]:
    utt2spk = _parse_key_value_file(split_dir / "utt2spk")
    entries: list[KaldiSegmentEntry] = []
    for line in (split_dir / "segments").read_text().splitlines():
        if not line.strip():
            continue
        parts = line.split()
        if len(parts) != 4:
            raise AmiDataError(f"Invalid segments line: {line}")
        utt_id = parts[0]
        speaker = utt2spk.get(utt_id)
        if speaker is None:
            raise AmiDataError(f"utt2spk missing entry for {utt_id}")
        entries.append(
            KaldiSegmentEntry(
                utterance_id=utt_id,
                recording_id=parts[1],
                speaker_id=speaker,
                start_time=float(parts[2]),
                end_time=float(parts[3]),
            )
        )
    return entries


def load_kaldi_der_reference(
    meeting_id: str,
    split_dir: str | Path,
    *,
    frame_step: float = KALDI_FRAME_STEP,
) -> list[TimedSpeakerSegment]:
    """DER reference from a built Kaldi split, quantized at the original
    recipe's 80-sample/8 kHz frame step (AMIKaldiData.swift:217-278)."""
    entries = [
        e for e in _segment_entries(Path(split_dir)) if e.recording_id == meeting_id
    ]
    if not entries:
        raise AmiDataError(f"AMI Kaldi data has no reference segments for {meeting_id}.")
    segments = [
        TimedSpeakerSegment(
            speaker_id=e.speaker_id, start_time=e.start_time, end_time=e.end_time
        )
        for e in entries
    ]
    return frame_aligned_der_reference(segments, frame_step=frame_step)


# ------------------------------------------------------------ RTTM staging


def ami_rttm_path(
    meeting: str, working_dir: str | Path, home_dir: str | Path
) -> Path:
    """RTTM lookup order (DiarizationBenchmarkUtils.swift:145-163): cached
    home copy first, then the forced-alignment repo's test/dev/train splits.
    Returns the first existing candidate, else the first candidate."""
    home_dir = Path(home_dir)
    working_dir = Path(working_dir)
    candidates = [
        home_dir / "FluidAudioDatasets" / "ami_official" / "rttm" / f"{meeting}.rttm",
        working_dir / "Datasets" / "diar-forced-alignment" / "AMI" / "test" / f"{meeting}.rttm",
        working_dir / "Datasets" / "diar-forced-alignment" / "AMI" / "dev" / f"{meeting}.rttm",
        working_dir / "Datasets" / "diar-forced-alignment" / "AMI" / "train" / f"{meeting}.rttm",
    ]
    for cand in candidates:
        if cand.exists():
            return cand
    return candidates[0]


def stage_ami_rttms(
    source_root: str | Path,
    destination_dir: str | Path,
    *,
    meeting_ids: list[str] | tuple[str, ...] | None = None,
    single_file: str | None = None,
    force: bool = False,
) -> tuple[int, int, list[str]]:
    """Copy forced-alignment RTTMs into the cache dir
    (DatasetDownloader.swift:286-352). Returns (copied, skipped, missing)."""
    source_root = Path(source_root)
    destination_dir = Path(destination_dir)
    if not source_root.exists():
        return (0, 0, [])
    destination_dir.mkdir(parents=True, exist_ok=True)

    if single_file is not None:
        selected: tuple[str, ...] = (single_file,)
    elif meeting_ids is not None:
        selected = tuple(meeting_ids)
    else:
        selected = AMI_TEST_MEETINGS

    copied, skipped, missing = 0, 0, []
    for meeting_id in selected:
        dest = destination_dir / f"{meeting_id}.rttm"
        if not force and dest.exists():
            skipped += 1
            continue
        source = next(
            (
                source_root / split / f"{meeting_id}.rttm"
                for split in ("test", "dev", "train")
                if (source_root / split / f"{meeting_id}.rttm").exists()
            ),
            None,
        )
        if source is None:
            missing.append(meeting_id)
            continue
        if dest.exists():
            dest.unlink()
        shutil.copyfile(source, dest)
        copied += 1
    return (copied, skipped, sorted(missing))
