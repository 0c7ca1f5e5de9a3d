"""PocketTTS text preprocessing: normalization, sentence/clause chunking.

Behavioral parity: reference `PocketTTS/Pipeline/PocketTtsSynthesizer.swift`
text statics (issue #584):
- `normalizeSmartQuotes` (:759): U+2018/2019/201C/201D -> ASCII.
- `normalizeForLanguage` (:779): French guillemets «» -> ", NBSP/narrow
  NBSP -> space; other languages are a no-op.
- `normalizeText` (:807): trim, language+smart-quote normalize, collapse
  whitespace; for full sentences strip trailing clause punctuation,
  capitalize, append a period, and pad short texts (8 leading spaces +
  3 frames-after-EOS); mid-sentence chunks preserve casing/punctuation and
  skip the padding (1 extra frame).
- `splitSentences` (:1147): split at .!? except after known abbreviations,
  single uppercase initials, or digit-adjacent periods.
- `splitAtClauseBoundaries`: , ; : except commas inside numbers (3,500).
- `splitAtWordBoundaries`: greedy token-budget packing; donates one word
  back when the tail would be a single orphaned word.
- `chunkTextWithMetadata`: sentences grouped into <= max_tokens chunks;
  oversized sentences split at clause then word boundaries with
  `is_mid_sentence` continuation tags that never merge across a sentence
  boundary.

Token counting is injected as a callable so the chunker works with the
SentencePiece tokenizer or any stand-in.

A copy of the JAX package's module of the same name (host code).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable

SHORT_TEXT_PAD_FRAMES = 3
LONG_TEXT_EXTRA_FRAMES = 1
SHORT_TEXT_WORD_THRESHOLD = 5
MAX_TOKENS_PER_CHUNK = 50

ABBREVIATIONS = frozenset(
    "dr mr mrs ms prof sr jr st vs etc inc ltd co corp dept univ govt approx "
    "avg est gen gov hon sgt cpl pvt capt lt col maj cmdr adm rev sen rep".split()
)

FRENCH_ABBREVIATIONS = frozenset(
    "m mm mme mmes mlle mlles mtre mtres dr drs pr prs me mes "
    "st ste sts stes etc cf ibid op cit ndlr nb "
    "p pp vol chap tome fig av bd bld rte no nos".split()
)


def abbreviations_for(language: str) -> frozenset[str]:
    if language.lower().startswith("french"):
        return FRENCH_ABBREVIATIONS
    return ABBREVIATIONS


@dataclass(frozen=True)
class TextChunk:
    text: str
    is_mid_sentence: bool


def fallback_char_tokens(text: str, vocab_size: int, max_tokens: int = 256) -> list[int]:
    """Char-level stand-in token ids used when no SentencePiece model is
    cached (PocketTtsManager._tokenize fallback; also the trained-fixture
    convention — one source of truth so training and inference cannot
    drift). Id 0 is reserved (BOS/pad)."""
    ids = [min(vocab_size - 1, 1 + (ord(c) % (vocab_size - 2)))
           for c in text[:max_tokens]]
    return ids or [1]


def normalize_smart_quotes(text: str) -> str:
    return (
        text.replace("‘", "'")
        .replace("’", "'")
        .replace("“", '"')
        .replace("”", '"')
    )


def normalize_for_language(text: str, language: str = "english") -> str:
    if language.lower().startswith("french"):
        return (
            text.replace("«", '"')
            .replace("»", '"')
            .replace(" ", " ")
            .replace(" ", " ")
        )
    return text


def normalize_text(
    text: str, is_mid_sentence: bool = False, language: str = "english"
) -> tuple[str, int]:
    """-> (normalized text, frames to keep after EOS detection)."""
    result = normalize_for_language(normalize_smart_quotes(text.strip()), language)
    result = re.sub(r"\s+", " ", result)

    if not is_mid_sentence:
        while result and result[-1] in ",;:":
            result = result[:-1]
        result = result.strip()
        if result and result[0].isalpha():
            result = result[0].upper() + result[1:]
        if result and result[-1] not in ".!?":
            result += "."

    word_count = len(result.split(" ")) if result else 0
    if not is_mid_sentence and word_count < SHORT_TEXT_WORD_THRESHOLD:
        result = " " * 8 + result
        frames_after_eos = SHORT_TEXT_PAD_FRAMES
    else:
        frames_after_eos = LONG_TEXT_EXTRA_FRAMES
    return result, frames_after_eos


def split_sentences(text: str, language: str = "english") -> list[str]:
    abbrev = abbreviations_for(language)
    sentences: list[str] = []
    current = ""
    for i, ch in enumerate(text):
        current += ch
        if ch not in ".!?":
            continue
        if ch == ".":
            trimmed = current.strip()
            without_period = trimmed[:-1]
            last_word = without_period.split(" ")[-1] if without_period else ""
            if last_word.lower() in abbrev:
                continue
            if len(last_word) == 1 and last_word.isupper():
                continue  # initials like "J."
            if i + 1 < len(text) and text[i + 1].isdigit():
                continue  # "3.5"
        trimmed = current.strip()
        if trimmed:
            sentences.append(trimmed)
        current = ""
    trimmed = current.strip()
    if trimmed:
        sentences.append(trimmed)
    return sentences


def split_at_clause_boundaries(text: str) -> list[str]:
    parts: list[str] = []
    current = ""
    for i, ch in enumerate(text):
        current += ch
        if ch not in ",;:":
            continue
        if ch == ",":
            prev_digit = i > 0 and text[i - 1].isdigit()
            next_digit = i + 1 < len(text) and text[i + 1].isdigit()
            if prev_digit and next_digit:
                continue  # "3,500"
        trimmed = current.strip()
        if trimmed:
            parts.append(trimmed)
        current = ""
    trimmed = current.strip()
    if trimmed:
        parts.append(trimmed)
    return parts


def split_at_word_boundaries(
    text: str, count_tokens: Callable[[str], int], max_tokens: int
) -> list[str]:
    words = text.split(" ")
    words = [w for w in words if w]
    if len(words) <= 1:
        return [text]
    chunks: list[str] = []
    current: list[str] = []
    for word in words:
        candidate = " ".join(current + [word])
        if count_tokens(candidate) > max_tokens and current:
            chunks.append(" ".join(current))
            current = [word]
        else:
            current.append(word)
    if current:
        chunks.append(" ".join(current))
    # De-orphan a single-word tail by donating one word back (issue #584).
    if len(chunks) >= 2 and len(chunks[-1].split(" ")) == 1:
        prev_words = chunks[-2].split(" ")
        if len(prev_words) >= 2:
            chunks[-1] = prev_words[-1] + " " + chunks[-1]
            chunks[-2] = " ".join(prev_words[:-1])
    return chunks


def split_oversized_sentence(
    text: str, count_tokens: Callable[[str], int], max_tokens: int
) -> list[str]:
    clause_parts = split_at_clause_boundaries(text)
    result: list[str] = []
    current = ""
    for part in clause_parts:
        candidate = part if not current else current + " " + part
        if count_tokens(candidate) <= max_tokens:
            current = candidate
        else:
            if current:
                result.append(current)
            if count_tokens(part) > max_tokens:
                result.extend(split_at_word_boundaries(part, count_tokens, max_tokens))
                current = ""
            else:
                current = part
    if current:
        result.append(current)
    return result or [text]


def chunk_text_with_metadata(
    text: str,
    count_tokens: Callable[[str], int],
    max_tokens: int = MAX_TOKENS_PER_CHUNK,
    language: str = "english",
) -> list[TextChunk]:
    normalized = normalize_for_language(normalize_smart_quotes(text.strip()), language)
    if count_tokens(normalized) <= max_tokens:
        return [TextChunk(text=normalized, is_mid_sentence=False)]

    pieces: list[TextChunk] = []
    for sentence in split_sentences(normalized, language):
        if count_tokens(sentence) <= max_tokens:
            pieces.append(TextChunk(sentence, is_mid_sentence=False))
        else:
            for idx, piece in enumerate(
                split_oversized_sentence(sentence, count_tokens, max_tokens)
            ):
                pieces.append(TextChunk(piece, is_mid_sentence=idx > 0))

    chunks: list[TextChunk] = []
    current: TextChunk | None = None
    for piece in pieces:
        if current is None:
            current = piece
            continue
        # A sentence-start piece never merges onto a mid-sentence chunk.
        if current.is_mid_sentence != piece.is_mid_sentence:
            chunks.append(current)
            current = piece
            continue
        candidate = current.text + " " + piece.text
        if count_tokens(candidate) <= max_tokens:
            current = TextChunk(candidate, current.is_mid_sentence)
        else:
            chunks.append(current)
            current = piece
    if current is not None:
        chunks.append(current)
    return chunks


def chunk_text(
    text: str,
    count_tokens: Callable[[str], int],
    max_tokens: int = MAX_TOKENS_PER_CHUNK,
    language: str = "english",
) -> list[str]:
    return [
        c.text
        for c in chunk_text_with_metadata(text, count_tokens, max_tokens, language)
    ]
