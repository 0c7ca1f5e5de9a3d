"""ASR configuration + result types.

Behavioral parity: reference `Parakeet/AsrTypes.swift:5-101` (`ASRConfig`,
`ASRResult`) and `TDT/Decoder/TdtConfig.swift`. Note `parallel_chunk_batch`
replaces the reference's `parallelChunkConcurrency` worker pool: windows are
stacked on the batch axis of one device call instead of fanned out to cloned
managers (SURVEY.md §2.10).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class TdtConfig:
    durations: tuple[int, ...] = (0, 1, 2, 3, 4)
    max_symbols_per_step: int = 10
    max_tokens_per_chunk: int = 512
    consecutive_blank_limit: int = 5
    include_token_duration: bool = True
    # how far into the next chunk a boundary-duplicated run may start
    # (reference `TdtConfig.boundarySearchFrames`, default 20)
    boundary_search_frames: int = 20


@dataclass(frozen=True)
class ASRConfig:
    sample_rate: int = 16_000
    tdt: TdtConfig = field(default_factory=TdtConfig)
    encoder_hidden_size: int = 1024
    # windows decoded per device batch (reference default concurrency 4);
    # values < 1 clamp to 1 (ASRConfigTests contract)
    parallel_chunk_batch: int = 4
    streaming_enabled: bool = True
    streaming_threshold: int = 480_000  # samples; above => disk-backed source
    mel_chunk_context: bool = True
    dual_decode_arbitration: bool = False
    prefer_silence_alignment: bool = False

    def __post_init__(self):
        if self.parallel_chunk_batch < 1:
            object.__setattr__(self, "parallel_chunk_batch", 1)


@dataclass(frozen=True)
class TokenTiming:
    token: str
    token_id: int
    start_time: float
    end_time: float
    confidence: float


@dataclass(frozen=True)
class WordTiming:
    """Word-level timing aggregated from sub-word `TokenTiming`s.

    Behavioral parity: reference `Parakeet/AsrTypes.swift:163-216`
    (`WordTiming`, `buildWordTimings`).
    """

    word: str
    start_time: float
    end_time: float


_WORD_BOUNDARY_MARKER = "▁"  # SentencePiece ▁
_SKIP_TOKENS = frozenset(("", "<blank>", "<pad>"))


def _is_word_boundary(token: str) -> bool:
    return token.startswith(_WORD_BOUNDARY_MARKER) or token.startswith(" ")


def _strip_word_boundary_prefix(token: str) -> str:
    # exactly ONE leading marker, reference `VocabularyRescorer+Utilities.swift:165-170`
    if token.startswith(_WORD_BOUNDARY_MARKER) or token.startswith(" "):
        return token[1:]
    return token


def build_word_timings(token_timings: list[TokenTiming]) -> list[WordTiming]:
    """Group sub-word token timings into word-level spans.

    Tokens whose raw piece starts with a word-boundary marker (`▁` or a
    leading space) begin a new word; the rest append to the current word. A
    word spans its first sub-word's start to its last sub-word's end. Empty /
    `<blank>` / `<pad>` pieces are skipped. Reference
    `AsrTypes.swift:182-216`, exercised by `WordTimingTests.swift`.
    """
    words: list[WordTiming] = []
    current = ""
    word_start = 0.0
    word_end = 0.0

    def flush() -> None:
        trimmed = current.strip()
        if trimmed:
            words.append(WordTiming(trimmed, word_start, word_end))

    for t in token_timings:
        token = t.token
        if token in _SKIP_TOKENS:
            continue
        starts_new = _is_word_boundary(token) or not current
        if starts_new and current:
            flush()
            current = ""
        if starts_new:
            current = _strip_word_boundary_prefix(token)
            word_start = t.start_time
        else:
            current += token
        word_end = t.end_time

    flush()
    return words


@dataclass
class ASRResult:
    text: str
    confidence: float
    duration: float
    processing_time: float
    token_timings: list[TokenTiming] = field(default_factory=list)
    # updated TDT decoder carry when the caller passed `decoder_state` /
    # single-window path (reference `AsrManager.transcribe(decoderState:)`)
    decoder_state: object = None

    @property
    def rtfx(self) -> float:
        return self.duration / self.processing_time if self.processing_time > 0 else 0.0
