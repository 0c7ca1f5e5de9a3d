"""Long-form audio windowing + overlap merge for batch ASR.

Behavioral parity: reference `TDT/ChunkProcessor.swift` (1119 LoC):
  - frame-aligned ~14.96 s windows reserving 80 ms mel-context prepend
    (`chunkSamples`, :64-79), 2 s frame-aligned overlap
  - regular or energy-based silence-aligned chunk starts with adaptive
    thresholds, valley fallback, speech-tail compression guard, and warmup
    prefix probing (:105-340, issue #594)
  - timestamp-sorted token-window merge: contiguous-run matching with LCS
    fallback, splice-safe token sets, case-variant folding (issue #706),
    midpoint fallback with word-boundary repair (issue #683), and seam-word
    duplicate collapse (:683-1119)

These rules are WER-bearing and ported exactly (as host logic). The device
difference is the execution plan: the reference decodes windows on a worker
pool of 4 cloned managers; here `plan_windows` emits a static window list that
the manager stacks into a batch for ONE encoder+decode call
(SURVEY.md §2.10 data-parallel mapping).
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass

import numpy as np

from fluidaudio_tpu_torch.asr.constants import ASRConstants
from fluidaudio_tpu_torch.asr.sequence_matcher import (
    SequenceMatch,
    find_contiguous_matches,
    find_longest_common_subsequence,
)
from fluidaudio_tpu_torch.utils.audio_source import AudioSampleSource


@dataclass(frozen=True)
class TokenWindow:
    token: int
    timestamp: int  # global encoder frame index
    confidence: float = 1.0
    duration: int = 0  # predicted TDT duration (encoder frames; 0 = unknown)


@dataclass(frozen=True)
class ChunkStartDecision:
    start: int
    use_warmup_prefix: bool


@dataclass(frozen=True)
class ChunkLayout:
    chunk_samples: int
    stride_samples: int
    mel_context_samples: int
    warmup_prefix_samples: int

    @property
    def window_samples(self) -> int:
        """Static per-window sample width (chunk + context prepend)."""
        return self.chunk_samples + max(self.mel_context_samples, self.warmup_prefix_samples)


@dataclass(frozen=True)
class WindowSpec:
    """One encoder window.

    Read `read_count` valid samples at `read_start` into a static-width buffer
    (`ChunkLayout.window_samples`); local encoder frame t maps to global frame
    `frame_offset + t`. Context (the 80 ms mel prepend, issue #264) is folded
    into `read_start`, mirroring the reference's `chunkStartOffset` timestamp
    accounting (`ChunkProcessor.swift:496`).
    """

    read_start: int
    read_count: int
    frame_offset: int
    is_last: bool


def _is_punct_or_symbol(ch: str) -> bool:
    return unicodedata.category(ch)[0] in ("P", "S")


def splice_safe_token_ids(vocabulary: dict[int, str]) -> set[int] | None:
    """IDs safe to start a spliced-in right window: word-initial or punctuation."""
    if not vocabulary:
        return None
    return {i for i, piece in vocabulary.items() if is_splice_safe_piece(piece)}


def is_splice_safe_piece(piece: str) -> bool:
    if not piece:
        return False
    if piece.startswith(ASRConstants.SENTENCEPIECE_WORD_BOUNDARY) or piece.startswith(" "):
        return True
    return all(_is_punct_or_symbol(c) for c in piece)


def case_variant_canonical_ids(vocabulary: dict[int, str]) -> dict[int, int] | None:
    """Map case-twin token IDs to a shared canonical (lowercase-preferred) ID."""
    if not vocabulary:
        return None
    groups: dict[str, list[int]] = {}
    for tid, piece in vocabulary.items():
        groups.setdefault(piece.lower(), []).append(tid)
    canon: dict[int, int] = {}
    for folded, ids in groups.items():
        if len(ids) < 2:
            continue
        canonical = next((i for i in ids if vocabulary[i] == folded), min(ids))
        for i in ids:
            canon[i] = canonical
    return canon or None


def _strip_word_boundary(piece: str) -> str:
    if piece.startswith(ASRConstants.SENTENCEPIECE_WORD_BOUNDARY):
        return piece[len(ASRConstants.SENTENCEPIECE_WORD_BOUNDARY) :]
    return piece.lstrip(" ")


class ChunkProcessor:
    """Stateless long-form chunking + merge engine over an AudioSampleSource."""

    OVERLAP_SECONDS: float = 2.0
    MEL_CONTEXT_SAMPLES: int = ASRConstants.SAMPLES_PER_ENCODER_FRAME  # 80 ms
    NO_MEL_WARMUP_PREFIX_FRAMES: int = 0  # arbitration path B uses 7

    def __init__(self, source: AudioSampleSource):
        self.source = source

    @property
    def total_samples(self) -> int:
        return self.source.sample_count

    def _read(self, offset: int, count: int) -> np.ndarray:
        return self.source.copy_samples(offset, count)

    # ------------------------------------------------------------------ layout

    def _effective_mel_context(self, mel_chunk_context: bool) -> int:
        return self.MEL_CONTEXT_SAMPLES if mel_chunk_context else 0

    def _effective_warmup_prefix(self, mel_chunk_context: bool, model_version: str | None) -> int:
        if mel_chunk_context or model_version != "v3":
            return 0
        return self.NO_MEL_WARMUP_PREFIX_FRAMES * ASRConstants.SAMPLES_PER_ENCODER_FRAME

    def _chunk_samples(self, mel_chunk_context: bool) -> int:
        fpe = ASRConstants.SAMPLES_PER_ENCODER_FRAME
        reserved = self._effective_mel_context(mel_chunk_context)
        max_actual = ASRConstants.MAX_MODEL_SAMPLES - reserved
        raw = max(max_actual - ASRConstants.MEL_HOP_SIZE, fpe)
        return raw // fpe * fpe

    def _overlap_samples(self, chunk_samples: int) -> int:
        fpe = ASRConstants.SAMPLES_PER_ENCODER_FRAME
        requested = int(self.OVERLAP_SECONDS * ASRConstants.SAMPLE_RATE)
        capped = min(requested, chunk_samples // 2)
        return capped // fpe * fpe

    def _stride_samples(self, chunk_samples: int) -> int:
        fpe = ASRConstants.SAMPLES_PER_ENCODER_FRAME
        raw = max(chunk_samples - self._overlap_samples(chunk_samples), fpe)
        return raw // fpe * fpe

    def chunk_layout(
        self, mel_chunk_context: bool = True, model_version: str | None = None
    ) -> ChunkLayout:
        chunk_samples = self._chunk_samples(mel_chunk_context)
        return ChunkLayout(
            chunk_samples=chunk_samples,
            stride_samples=self._stride_samples(chunk_samples),
            mel_context_samples=self._effective_mel_context(mel_chunk_context),
            warmup_prefix_samples=self._effective_warmup_prefix(mel_chunk_context, model_version),
        )

    # ------------------------------------------------------------ chunk starts

    def chunk_starts(
        self,
        layout: ChunkLayout,
        prefer_silence_alignment: bool = False,
    ) -> list[ChunkStartDecision]:
        if not prefer_silence_alignment and layout.warmup_prefix_samples == 0:
            return self.regular_chunk_starts(layout.stride_samples)
        return self.silence_aligned_chunk_starts(
            layout.chunk_samples,
            layout.stride_samples,
            can_use_warmup_prefix=layout.warmup_prefix_samples > 0,
        )

    def regular_chunk_starts(self, stride_samples: int) -> list[ChunkStartDecision]:
        starts = [ChunkStartDecision(0, False)]
        s = stride_samples
        while s < self.total_samples:
            starts.append(ChunkStartDecision(s, False))
            s += stride_samples
        return starts

    def silence_aligned_chunk_starts(
        self, chunk_samples: int, stride_samples: int, can_use_warmup_prefix: bool
    ) -> list[ChunkStartDecision]:
        fpe = ASRConstants.SAMPLES_PER_ENCODER_FRAME
        sr = ASRConstants.SAMPLE_RATE
        silence_radius = max(1, int(4.0 * sr) // fpe)
        valley_radius = max(1, int(0.5 * sr) // fpe)
        half_energy_window = fpe
        minimum_overlap = fpe * 6

        starts = [ChunkStartDecision(0, False)]
        previous_start = 0
        target = stride_samples

        while target < self.total_samples:
            target_frame = target // fpe
            latest_covered = previous_start + chunk_samples - minimum_overlap
            target_start = min(max(target_frame * fpe, previous_start + fpe), latest_covered)

            cand = self._best_boundary_candidate(
                target_frame, silence_radius, previous_start, latest_covered, half_energy_window
            )
            near_silence = self._is_near_silence(cand)

            use_warmup = False
            if near_silence:
                should_warmup = (
                    self._should_use_warmup_prefix(cand[0]) if can_use_warmup_prefix else False
                )
                compresses = False
                if should_warmup and cand[0] < target_start:
                    compresses = self._would_compress_speech_tail(
                        cand[0], target_start, chunk_samples, minimum_overlap, cand[2],
                        half_energy_window,
                    )
                if compresses:
                    best_start = target_start
                else:
                    best_start = cand[0]
                    use_warmup = should_warmup
            else:
                valley = self._best_boundary_candidate(
                    target_frame, valley_radius, previous_start, latest_covered, half_energy_window
                )
                best_start = valley[0] if self._is_usable_valley(valley) else target_start

            if best_start <= previous_start:
                best_start = min(previous_start + stride_samples, self.total_samples)

            starts.append(ChunkStartDecision(best_start, use_warmup))
            previous_start = best_start
            target += stride_samples

        # silence alignment can pull starts up to the search radius behind
        # their stride target; the fixed target grid may then exit with an
        # uncovered tail longer than one window (plan_windows forces the
        # final chunk_end to total_samples, which would overflow the static
        # window buffer). Append regular-stride starts until covered.
        while previous_start + chunk_samples < self.total_samples:
            previous_start += stride_samples
            starts.append(ChunkStartDecision(previous_start, False))

        return starts

    def _best_boundary_candidate(
        self,
        target_frame: int,
        radius_frames: int,
        previous_start: int,
        latest_covered: int,
        half_energy_window: int,
    ) -> tuple[int, float, float]:
        fpe = ASRConstants.SAMPLES_PER_ENCODER_FRAME
        lower = max(1, target_frame - radius_frames)
        upper = min((self.total_samples - 1) // fpe, target_frame + radius_frames)
        target_start = min(max(target_frame * fpe, previous_start + fpe), latest_covered)

        best_start, best_score = target_start, float("inf")
        scores: list[float] = []
        for frame in range(lower, upper + 1):
            candidate = frame * fpe
            if candidate <= previous_start or candidate > latest_covered:
                continue
            score = self._boundary_energy(candidate, half_energy_window)
            scores.append(score)
            if score < best_score:
                best_score, best_start = score, candidate
        if not scores:
            return (target_start, float("inf"), 0.0)
        median = sorted(scores)[len(scores) // 2]
        return (best_start, best_score, median)

    @staticmethod
    def _adaptive_threshold(median: float, ratio: float) -> float:
        return median * ratio if median > 0 else 0.0

    def _is_near_silence(self, cand: tuple[int, float, float]) -> bool:
        return cand[1] <= self._adaptive_threshold(cand[2], 0.05)

    def _is_usable_valley(self, cand: tuple[int, float, float]) -> bool:
        return cand[1] <= self._adaptive_threshold(cand[2], 0.35)

    def _would_compress_speech_tail(
        self,
        candidate_start: int,
        target_start: int,
        chunk_samples: int,
        minimum_overlap: int,
        median: float,
        half_energy_window: int,
    ) -> bool:
        if median <= 0:
            return False
        forced_next = candidate_start + chunk_samples - minimum_overlap
        if forced_next >= self.total_samples:
            return False
        speechy = median * 0.8
        return (
            self._boundary_energy(target_start, half_energy_window) > speechy
            and self._boundary_energy(forced_next, half_energy_window) > speechy
        )

    def _should_use_warmup_prefix(self, center: int) -> bool:
        sr = ASRConstants.SAMPLE_RATE
        lookahead = int(0.5 * sr)
        min_quiet = int(0.2 * sr)
        window = max(1, sr // 50)  # 20 ms
        threshold = 0.003
        offset = 0
        quiet = 0
        while offset < lookahead:
            start = center + offset
            if start >= self.total_samples:
                break
            count = min(window, self.total_samples - start, lookahead - offset)
            if count <= 0:
                break
            samples = self._read(start, count)
            rms = float(np.sqrt(np.mean(samples**2))) if samples.size else 0.0
            if rms >= threshold:
                break
            quiet += count
            if quiet >= min_quiet:
                return False
            offset += count
        return True

    def _boundary_energy(self, center: int, half_window: int) -> float:
        start = max(0, center - half_window)
        end = min(self.total_samples, center + half_window)
        if end <= start:
            return 0.0
        samples = self._read(start, end - start)
        return float(np.mean(samples**2))

    # -------------------------------------------------------------- window plan

    def plan_windows(
        self,
        mel_chunk_context: bool = True,
        model_version: str | None = None,
        prefer_silence_alignment: bool = False,
    ) -> tuple[ChunkLayout, list[WindowSpec]]:
        """Static window list the manager batches into one encoder call."""
        layout = self.chunk_layout(mel_chunk_context, model_version)
        decisions = self.chunk_starts(layout, prefer_silence_alignment)
        fpe = ASRConstants.SAMPLES_PER_ENCODER_FRAME
        windows: list[WindowSpec] = []
        for i, decision in enumerate(decisions):
            chunk_start = decision.start
            candidate_end = chunk_start + layout.chunk_samples
            is_last = i == len(decisions) - 1
            chunk_end = self.total_samples if is_last else min(candidate_end, self.total_samples)
            warmup = layout.warmup_prefix_samples if decision.use_warmup_prefix else 0
            context = warmup if warmup > 0 else (layout.mel_context_samples if chunk_start > 0 else 0)
            read_start = max(0, chunk_start - context)
            windows.append(
                WindowSpec(
                    read_start=read_start,
                    read_count=chunk_end - read_start,
                    frame_offset=read_start // fpe,
                    is_last=is_last,
                )
            )
        return layout, windows

    # -------------------------------------------------------------------- merge

    @property
    def _overlap_frames(self) -> int:
        return round(self.OVERLAP_SECONDS / ASRConstants.SECONDS_PER_ENCODER_FRAME)

    def merge_chunks(
        self,
        left: list[TokenWindow],
        right: list[TokenWindow],
        splice_safe_ids: set[int] | None = None,
        case_variant_ids: dict[int, int] | None = None,
    ) -> list[TokenWindow]:
        if not left:
            return right
        if not right:
            return left

        frame_dur = ASRConstants.SECONDS_PER_ENCODER_FRAME
        overlap_dur = self.OVERLAP_SECONDS
        half_overlap = overlap_dur / 2

        left_end_time = left[-1].timestamp * frame_dur + frame_dur
        right_start_time = right[0].timestamp * frame_dur

        if left_end_time <= right_start_time:
            return left + right

        overlap_left = [
            (i, tok)
            for i, tok in enumerate(left)
            if tok.timestamp * frame_dur + frame_dur > right_start_time - overlap_dur
        ]
        overlap_right = [
            (i, tok)
            for i, tok in enumerate(right)
            if tok.timestamp * frame_dur < left_end_time + overlap_dur
        ]

        if len(overlap_left) < 2 or len(overlap_right) < 2:
            return self._merge_by_midpoint(
                left, right, left_end_time, right_start_time, frame_dur, splice_safe_ids
            )

        def ids_match(a: int, b: int) -> bool:
            if a == b:
                return True
            if case_variant_ids is None:
                return False
            ca, cb = case_variant_ids.get(a), case_variant_ids.get(b)
            return ca is not None and ca == cb

        def matcher(l: tuple[int, TokenWindow], r: tuple[int, TokenWindow]) -> bool:
            if not ids_match(l[1].token, r[1].token):
                return False
            return abs(l[1].timestamp - r[1].timestamp) * frame_dur < half_overlap

        minimum_pairs = max(len(overlap_left) // 2, 1)
        contiguous = find_contiguous_matches(overlap_left, overlap_right, matcher)
        pairs = [(m.left_start, m.right_start) for m in contiguous]

        if len(pairs) < minimum_pairs:
            lcs = find_longest_common_subsequence(overlap_left, overlap_right, matcher)
            if not lcs:
                return self._merge_by_midpoint(
                    left, right, left_end_time, right_start_time, frame_dur, splice_safe_ids
                )
            pairs = [(m.left_start, m.right_start) for m in lcs]

        return self._merge_using_matches(
            pairs, overlap_left, overlap_right, left, right, splice_safe_ids
        )

    def _merge_using_matches(
        self,
        matches: list[tuple[int, int]],
        overlap_left: list[tuple[int, TokenWindow]],
        overlap_right: list[tuple[int, TokenWindow]],
        left: list[TokenWindow],
        right: list[TokenWindow],
        splice_safe_ids: set[int] | None,
    ) -> list[TokenWindow]:
        left_indices = [overlap_left[a][0] for a, _ in matches]
        right_indices = [overlap_right[b][0] for _, b in matches]

        result: list[TokenWindow] = []
        if left_indices and left_indices[0] > 0:
            result.extend(left[: left_indices[0]])

        for idx in range(len(matches)):
            li, ri = left_indices[idx], right_indices[idx]
            result.append(left[li])
            if idx >= len(matches) - 1:
                continue
            nli, nri = left_indices[idx + 1], right_indices[idx + 1]
            gap_left = left[li + 1 : nli] if nli > li + 1 else []
            gap_right = right[ri + 1 : nri] if nri > ri + 1 else []
            result.extend(gap_right if len(gap_right) > len(gap_left) else gap_left)

        if right_indices and right_indices[-1] + 1 < len(right):
            last_right = right_indices[-1]
            tail = right[last_right + 1 :]
            if splice_safe_ids is not None and tail and tail[0].token not in splice_safe_ids:
                # splice lands mid-word (issue #683): re-splice at a word boundary
                word_start = self._word_initial_index(right, last_right, splice_safe_ids)
                if word_start is not None and self._pop_seam_word(result, splice_safe_ids):
                    result.extend(right[word_start:])
                else:
                    if left_indices:
                        cursor = left_indices[-1] + 1
                        while cursor < len(left) and left[cursor].token not in splice_safe_ids:
                            result.append(left[cursor])
                            cursor += 1
                    resume = next(
                        (i for i, t in enumerate(tail) if t.token in splice_safe_ids), None
                    )
                    if resume is not None:
                        result.extend(tail[resume:])
            else:
                result.extend(tail)

        return result

    @staticmethod
    def _word_initial_index(
        stream: list[TokenWindow], anchor: int, safe_ids: set[int]
    ) -> int | None:
        for i in range(anchor, -1, -1):
            if stream[i].token in safe_ids:
                return i
        return None

    @staticmethod
    def _pop_seam_word(result: list[TokenWindow], safe_ids: set[int]) -> bool:
        max_pieces = 12
        cursor = len(result) - 1
        inspected = 0
        while cursor >= 0 and inspected < max_pieces:
            if result[cursor].token in safe_ids:
                del result[cursor:]
                return True
            cursor -= 1
            inspected += 1
        return False

    def _merge_by_midpoint(
        self,
        left: list[TokenWindow],
        right: list[TokenWindow],
        left_end_time: float,
        right_start_time: float,
        frame_dur: float,
        splice_safe_ids: set[int] | None,
    ) -> list[TokenWindow]:
        cutoff = (left_end_time + right_start_time) / 2
        left_end = next(
            (i for i, t in enumerate(left) if t.timestamp * frame_dur >= cutoff), len(left)
        )
        right_start = next(
            (i for i, t in enumerate(right) if t.timestamp * frame_dur >= cutoff), len(right)
        )
        if splice_safe_ids is not None:
            if left_end > 0:
                while left_end < len(left) and left[left_end].token not in splice_safe_ids:
                    left_end += 1
            while right_start < len(right) and right[right_start].token not in splice_safe_ids:
                right_start += 1
        return left[:left_end] + right[right_start:]

    # ------------------------------------------------------------ seam collapse

    def collapse_seam_word_duplicates(
        self, tokens: list[TokenWindow], vocabulary: dict[int, str]
    ) -> list[TokenWindow]:
        """Drop adjacent case-only duplicates of a seam word (issue #706)."""
        if not vocabulary or len(tokens) < 2:
            return tokens
        overlap_frames = self._overlap_frames

        def piece(tid: int) -> str:
            return vocabulary.get(tid, "")

        def starts_word(tid: int) -> bool:
            p = piece(tid)
            return p.startswith(ASRConstants.SENTENCEPIECE_WORD_BOUNDARY) or p.startswith(" ")

        words: list[dict] = []
        for tok in tokens:
            if not words or starts_word(tok.token):
                words.append({"tokens": [tok], "start": tok.timestamp})
            else:
                words[-1]["tokens"].append(tok)

        for w in words:
            text = "".join(_strip_word_boundary(piece(t.token)) for t in w["tokens"])
            w["ends_sentence"] = bool(text) and text[-1] in ".?!:"
            w["core"] = _strip_punct_ws(text)

        keep = [True] * len(words)
        last_kept = -1
        for i in range(len(words)):
            if last_kept < 0:
                last_kept = i
                continue
            prev, cur = words[last_kept], words[i]
            pc, cc = prev["core"], cur["core"]
            is_dup = (
                bool(pc)
                and bool(cc)
                and pc != cc
                and pc.lower() == cc.lower()
                and cc[:1].isalpha()
                and not prev["ends_sentence"]
                and cur["start"] - prev["start"] <= overlap_frames
            )
            if not is_dup:
                last_kept = i
                continue
            if cc == cc.lower() and pc != pc.lower():
                keep[last_kept] = False
                last_kept = i
            else:
                keep[i] = False

        out: list[TokenWindow] = []
        for i, w in enumerate(words):
            if keep[i]:
                out.extend(w["tokens"])
        return out


def _strip_punct_ws(text: str) -> str:
    start, end = 0, len(text)
    while start < end and (_is_strip_char(text[start])):
        start += 1
    while end > start and (_is_strip_char(text[end - 1])):
        end -= 1
    return text[start:end]


def _is_strip_char(ch: str) -> bool:
    return ch.isspace() or unicodedata.category(ch).startswith("P")
