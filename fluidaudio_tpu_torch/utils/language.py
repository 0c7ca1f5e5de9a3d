"""Script-aware token filtering for multilingual decode.

Behavioral parity: reference `Shared/TokenLanguageFilter.swift`:
`Language` enum (locales incl. Latin-Slavic prone to Cyrillic confusion,
`:4-52`) -> `Script` (latin/cyrillic/greek); `matches` is Unicode-RANGE
based — every character of the SentencePiece-boundary-stripped token must
sit inside the target script's blocks (Latin: ASCII + Latin-1 + Ext-A/B +
combining marks + Ext-Additional; Cyrillic/Greek: own block + script-neutral
ASCII with A-Z/a-z explicitly rejected; `:79-135`) so mixed-script tokens
match NO script; `filter_top_k` returns the highest-logit in-script
candidate with a top-K-only softmax probability, or None (`:139-195`).

Extended beyond the reference with CJK/Kana/Hangul/Arabic/Hebrew/Devanagari
scripts (unicodedata-name based) for the SenseVoice/multilingual families,
plus the decode-loop English-word blocklist from `TdtDecoderV3.swift`.

A copy of `fluidaudio_tpu/utils/language.py` (importing the JAX package
imports JAX, so the port carries its own).
"""

from __future__ import annotations

import math
import unicodedata
from dataclasses import dataclass
from enum import Enum

SENTENCEPIECE_BOUNDARY = "▁"  # ▁


class Script(Enum):
    LATIN = "latin"
    CYRILLIC = "cyrillic"
    GREEK = "greek"
    CJK = "cjk"
    ARABIC = "arabic"
    HEBREW = "hebrew"
    DEVANAGARI = "devanagari"
    HANGUL = "hangul"
    KANA = "kana"
    OTHER = "other"


LANGUAGE_SCRIPTS: dict[str, Script] = {
    **{l: Script.LATIN for l in (
        "en es fr it pt de nl pl cs ro hu sv da no fi tr id ms vi ca gl hr sk sl"
        " et lv lt mt bs".split()
    )},
    **{l: Script.CYRILLIC for l in "ru uk bg sr mk be".split()},
    "el": Script.GREEK,
    "zh": Script.CJK,
    "ja": Script.KANA,
    "ko": Script.HANGUL,
    "ar": Script.ARABIC,
    "he": Script.HEBREW,
    "hi": Script.DEVANAGARI,
}


def _is_ascii_letter(v: int) -> bool:
    return 0x41 <= v <= 0x5A or 0x61 <= v <= 0x7A


def _latin_char_ok(v: int) -> bool:
    return (
        0x0020 <= v <= 0x007F  # ASCII
        or 0x00A0 <= v <= 0x00FF  # Latin-1
        or 0x0100 <= v <= 0x017F  # Latin Extended-A
        or 0x0180 <= v <= 0x024F  # Latin Extended-B
        or 0x0300 <= v <= 0x036F  # Combining Diacritical Marks (NFD)
        or 0x1E00 <= v <= 0x1EFF  # Latin Extended Additional
    )


def _cyrillic_char_ok(v: int) -> bool:
    if 0x0400 <= v <= 0x04FF:
        return True
    # ASCII is script-neutral except letters (which overlap Latin).
    if 0x0020 <= v <= 0x007F:
        return not _is_ascii_letter(v)
    return False


def _greek_char_ok(v: int) -> bool:
    if 0x0370 <= v <= 0x03FF or 0x1F00 <= v <= 0x1FFF or 0x0300 <= v <= 0x036F:
        return True
    if 0x0020 <= v <= 0x007F:
        return not _is_ascii_letter(v)
    return False


def char_script(ch: str) -> Script:
    """Unicode-name classification for the scripts beyond the reference."""
    if not ch.isalpha():
        return Script.OTHER
    try:
        name = unicodedata.name(ch)
    except ValueError:
        return Script.OTHER
    if "CJK" in name or "IDEOGRAPH" in name:
        return Script.CJK
    for script in ("LATIN", "CYRILLIC", "GREEK", "ARABIC", "HEBREW", "DEVANAGARI",
                   "HANGUL"):
        if script in name:
            return Script[script]
    if "HIRAGANA" in name or "KATAKANA" in name:
        return Script.KANA
    return Script.OTHER


def matches_script(text: str, script: Script) -> bool:
    """Reference `TokenLanguageFilter.matches` (:79-135): every character of
    the boundary-stripped token must be compatible with `script`; pure
    boundary markers are script-neutral (True)."""
    cleaned = text.replace(SENTENCEPIECE_BOUNDARY, "")
    if not cleaned:
        return True
    if script is Script.LATIN:
        return all(_latin_char_ok(ord(c)) for c in cleaned)
    if script is Script.CYRILLIC:
        return all(_cyrillic_char_ok(ord(c)) for c in cleaned)
    if script is Script.GREEK:
        return all(_greek_char_ok(ord(c)) for c in cleaned)
    # Extension scripts: all alphabetic chars must classify into the target
    # script; non-alpha characters are script-neutral. Japanese (KANA)
    # additionally accepts CJK ideographs (kanji).
    acceptable = {script, Script.CJK} if script is Script.KANA else {script}
    return all(
        (not c.isalpha()) or char_script(c) in acceptable for c in cleaned
    )


def filter_top_k(
    top_k_ids: list[int],
    top_k_logits: list[float],
    vocabulary: dict[int, str],
    preferred_script: Script,
) -> tuple[int, float] | None:
    """Reference `filterTopK` (:139-195): highest-logit in-script candidate
    (first match wins over the -inf sentinel; input order is not assumed
    sorted); probability is a softmax over the top-K logits only. None when
    no candidate matches or inputs are empty. Missing vocabulary entries are
    skipped."""
    count = min(len(top_k_ids), len(top_k_logits))
    if count == 0:
        return None
    best_idx = -1
    best_logit = -math.inf
    for idx in range(count):
        text = vocabulary.get(top_k_ids[idx])
        if text is None or not matches_script(text, preferred_script):
            continue
        logit = top_k_logits[idx]
        if best_idx < 0 or logit > best_logit:
            best_logit, best_idx = logit, idx
    if best_idx < 0:
        return None
    max_logit = max(top_k_logits[:count])
    if not math.isfinite(max_logit):
        return top_k_ids[best_idx], 0.0
    sum_exp = sum(math.exp(l - max_logit) for l in top_k_logits[:count])
    if sum_exp <= 0:
        return top_k_ids[best_idx], 0.0
    prob = math.exp(top_k_logits[best_idx] - max_logit) / sum_exp
    return top_k_ids[best_idx], max(0.0, min(1.0, prob))


@dataclass
class TokenLanguageFilter:
    """Precomputes which token ids belong to a language's script."""

    language: str
    vocabulary: dict[int, str]
    # The reference's full English-exclusive word list (TdtDecoderV3.swift:
    # 40-78 maps these to Parakeet-v3 SentencePiece ids; we match on the
    # piece text so any vocabulary works).
    english_blocklist: frozenset[str] = frozenset(
        "the and they you with that this have from was were are been "
        "would could will their there when what where which who not "
        "but so it we our your my him her them these".split()
    )

    def __post_init__(self):
        self.script = LANGUAGE_SCRIPTS.get(self.language, Script.LATIN)
        self.allowed: set[int] = set()
        for tid, piece in self.vocabulary.items():
            if not matches_script(piece, self.script):
                continue
            # English blocklist: demote common English words when the target
            # is non-English Latin (ref TdtDecoderV3 English blocklist).
            core = piece.replace(SENTENCEPIECE_BOUNDARY, "").strip()
            if (
                self.script is Script.LATIN
                and self.language != "en"
                and core.lower() in self.english_blocklist
            ):
                continue
            self.allowed.add(tid)

    def matches(self, text: str) -> bool:
        return matches_script(text, self.script)

    def rerank_top_k(self, token_ids: list[int], scores: list[float]) -> int:
        """Best allowed token from a top-K candidate list (fallback: argmax)."""
        best, best_score = None, float("-inf")
        for tid, s in zip(token_ids, scores):
            if tid in self.allowed and s > best_score:
                best, best_score = tid, s
        if best is not None:
            return best
        return token_ids[int(max(range(len(scores)), key=lambda i: scores[i]))]
