"""Scoring-side text normalization (lowercase, strip punctuation, number words).

Behavioral parity: reference CLI `TextNormalizer` (697 LoC, scoring
normalization — distinct from the runtime ITN engine): fold case, drop
punctuation, collapse whitespace, normalize common contractions so WER
compares what was said rather than orthography.
"""

from __future__ import annotations

import re
import unicodedata

_CONTRACTIONS = {
    "won't": "will not", "can't": "cannot", "n't": " not", "'re": " are",
    "'ve": " have", "'ll": " will", "'d": " would", "'m": " am",
    "gonna": "going to", "wanna": "want to", "gotta": "got to",
}


def normalize_for_scoring(text: str) -> str:
    t = text.lower()
    for k, v in _CONTRACTIONS.items():
        t = t.replace(k, v)
    t = unicodedata.normalize("NFKD", t)
    t = "".join(c for c in t if not unicodedata.combining(c))
    t = re.sub(r"[^\w\s']", " ", t)
    t = t.replace("'", "")
    t = re.sub(r"\s+", " ", t)
    return t.strip()


_BRACKETED = re.compile(r"[<\[][^>\]]*[>\]]|\([^)]*\)")


def basic_normalize(text: str, spell_out_lang: str | None = None) -> str:
    """Whisper `BasicTextNormalizer`-equivalent for non-English Latin scripts
    (reference `TextNormalizer.basicNormalize`): lowercase, drop bracketed
    asides, NFKC, fold punctuation/symbols to spaces, KEEP diacritics
    (unlike `normalize_for_scoring`, which strips them for English).

    `spell_out_lang` additionally replaces digit runs with spelled-out
    cardinals (`metrics/spellout.py`) — NVIDIA's multilingual FLEURS scoring
    ITN pass (`NemotronMultilingualFleursBenchmark.swift:100-113`)."""
    t = _BRACKETED.sub(" ", text)
    t = unicodedata.normalize("NFKC", t).lower()
    if spell_out_lang is not None:
        from fluidaudio_tpu_torch.metrics.spellout import spell_out_numbers

        t = spell_out_numbers(t, spell_out_lang)
    # punctuation/symbols/marks -> space; keep letters+digits of any script
    t = "".join(
        " " if unicodedata.category(c)[0] in ("P", "S", "M") else c for c in t
    )
    return re.sub(r"\s+", " ", t).strip()


# FLEURS codes whose standard community scoring is character-level (word
# tokenization is meaningless for no-space scripts): reference
# `WERCalculator.isCJKLanguage`.
_CJK_PREFIXES = ("cmn", "zh", "yue", "ja", "ko", "th")


def is_cjk_language(code: str) -> bool:
    c = code.lower()
    return any(c == p or c.startswith(p + "_") or c.startswith(p + "-")
               for p in _CJK_PREFIXES)


def cjk_chars(text: str) -> list[str]:
    """Character tokens for CJK scoring: normalized, whitespace removed."""
    t = unicodedata.normalize("NFKC", text).lower()
    t = "".join(
        "" if unicodedata.category(c)[0] in ("P", "S", "Z", "C") else c
        for c in t
    )
    return list(t)
