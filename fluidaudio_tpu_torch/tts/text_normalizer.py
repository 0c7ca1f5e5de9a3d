"""TTS input normalization: written form -> spoken form (English).

Behavioral parity: reference `TTS/EnglishTextNormalizer` (176 LoC): digits,
ordinals, currency, percentages, years, decimals -> number words so the
phonemizer never sees raw digits.
"""

from __future__ import annotations

import re

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
         "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
         "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand"), (100, "hundred")]
_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + (" " + _ONES[rem] if rem else "")
    for scale, name in _SCALE:
        if n >= scale:
            major, rem = divmod(n, scale)
            out = number_to_words(major) + " " + name
            if rem:
                out += " " + number_to_words(rem)
            return out
    return str(n)


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    parts = words.rsplit(" ", 1)
    last = parts[-1]
    if last in _ORDINAL_SPECIAL:
        parts[-1] = _ORDINAL_SPECIAL[last]
    elif last.endswith("y"):
        parts[-1] = last[:-1] + "ieth"
    else:
        parts[-1] = last + "th"
    return " ".join(parts)


def year_to_words(n: int) -> str:
    if 1100 <= n <= 1999 and n % 100:
        hi, lo = divmod(n, 100)
        lo_words = ("oh " + _ONES[lo]) if lo < 10 else number_to_words(lo)
        return f"{number_to_words(hi)} {lo_words}"
    if 2000 <= n <= 2009:
        return number_to_words(n)
    if 2010 <= n <= 2099:
        return f"{number_to_words(20)} {number_to_words(n - 2000)}"
    return number_to_words(n)


_CURRENCY = {"$": "dollars", "€": "euros", "£": "pounds", "¥": "yen"}


def normalize_for_tts(text: str) -> str:
    t = text

    def currency(m):
        sym, amount = m.group(1), m.group(2)
        unit = _CURRENCY[sym]
        if "." in amount:
            whole, cents = amount.split(".")
            return (
                f"{number_to_words(int(whole.replace(',', '') or 0))} {unit} "
                f"and {number_to_words(int(cents))} cents"
            )
        n = int(amount.replace(",", ""))
        return f"{number_to_words(n)} {unit}"

    t = re.sub(r"([$€£¥])([\d,]+(?:\.\d+)?)", currency, t)
    t = re.sub(r"(\d+(?:\.\d+)?)\s*%", lambda m: _decimal_words(m.group(1)) + " percent", t)
    t = re.sub(r"\b(\d+)(st|nd|rd|th)\b", lambda m: ordinal_to_words(int(m.group(1))), t)
    # decimals BEFORE years: "3.1415" must not have its fraction read as a
    # year (\b holds across the dot, so year-first mangled such decimals)
    t = re.sub(r"\b\d+\.\d+\b", lambda m: _decimal_words(m.group(0)), t)
    # years: standalone 4-digit numbers in a plausible range
    t = re.sub(
        r"\b(1[1-9]\d\d|20\d\d)\b", lambda m: year_to_words(int(m.group(1))), t
    )
    t = re.sub(r"\b\d[\d,]*\b", lambda m: number_to_words(int(m.group(0).replace(",", ""))), t)
    return re.sub(r"\s+", " ", t).strip()


def _decimal_words(s: str) -> str:
    if "." not in s:
        return number_to_words(int(s))
    whole, frac = s.split(".")
    digits = " ".join(_ONES[int(d)] for d in frac)
    return f"{number_to_words(int(whole))} point {digits}"


# ---------------------------------------------------------------------------
# Conservative raw-text pass (reference TTS/Shared/EnglishTextNormalizer.swift,
# issue #711): only STRICT STANDALONE numeric forms are rewritten; anything
# ambiguous or structured (versions 1.2.3, grouped 1,234, embedded word26,
# loose 1:49 without meridiem, invalid 1:99 PM, 24-hour 13:49) is left
# untouched. Spelling reuses the SSML SayAsInterpreter with hyphens spaced.
# ---------------------------------------------------------------------------

# A standalone number must not be glued to a letter, digit, or a `. , :`
# that binds it into a word/version/group/clock. The right edge still allows
# a trailing sentence period: `.`/`,`/`:` only disqualifies when itself
# followed by a digit.
_LEAD = r"(?<![A-Za-z0-9.,:])"
_TRAIL = r"(?![A-Za-z0-9])(?![.,:][0-9])"

_MERIDIEM_RE = re.compile(
    _LEAD + r"(1[0-2]|[1-9]):([0-5][0-9])\s*([AaPp])(?:\.[Mm]\.?|[Mm])(?![A-Za-z])"
)
_EN_DECIMAL_RE = re.compile(_LEAD + r"([0-9]+)\.([0-9]+)" + _TRAIL)
_EN_ORDINAL_RE = re.compile(_LEAD + r"([0-9]+)(st|nd|rd|th)(?![A-Za-z])")
_LEADING_ZERO_RE = re.compile(_LEAD + r"(0[0-9]+)" + _TRAIL)
_EN_CARDINAL_RE = re.compile(_LEAD + r"([0-9]+)" + _TRAIL)


def _spaced_say_as(content: str, kind: str) -> str:
    from fluidaudio_tpu_torch.tts.ssml import interpret_say_as

    return interpret_say_as(content, kind).replace("-", " ")


def _expected_ordinal_suffix(n: int) -> str:
    if 11 <= n % 100 <= 13:
        return "th"
    return {1: "st", 2: "nd", 3: "rd"}.get(n % 10, "th")


def english_normalize(text: str) -> str:
    """Rewrite strict standalone integers / valid ordinals / decimals /
    leading-zero digit strings / 12-hour meridiem times to spoken words.
    Passes run most-specific-first so a meridiem time is consumed before
    its bare digits and a decimal before its integer part."""

    def meridiem(m: re.Match) -> str:
        spoken = _spaced_say_as(f"{m.group(1)}:{m.group(2)}", "time")
        if any(c.isdigit() for c in spoken):
            return m.group(0)
        suffix = "p m" if m.group(3).lower() == "p" else "a m"
        return f"{spoken} {suffix}"

    def decimal(m: re.Match) -> str:
        int_part = _spaced_say_as(m.group(1), "cardinal")
        frac_part = _spaced_say_as(m.group(2), "digits")
        if any(c.isdigit() for c in int_part + frac_part):
            return m.group(0)
        return f"{int_part} point {frac_part}"

    def ordinal(m: re.Match) -> str:
        n = int(m.group(1))
        if _expected_ordinal_suffix(n) != m.group(2).lower():
            return m.group(0)  # 1th / 13st: not a grammatical ordinal
        spoken = _spaced_say_as(m.group(1), "ordinal")
        return m.group(0) if any(c.isdigit() for c in spoken) else spoken

    def leading_zero(m: re.Match) -> str:
        spoken = _spaced_say_as(m.group(1), "digits")
        return m.group(0) if any(c.isdigit() for c in spoken) else spoken

    def cardinal(m: re.Match) -> str:
        spoken = _spaced_say_as(m.group(1), "cardinal")
        return m.group(0) if any(c.isdigit() for c in spoken) else spoken

    text = _MERIDIEM_RE.sub(meridiem, text)
    text = _EN_DECIMAL_RE.sub(decimal, text)
    text = _EN_ORDINAL_RE.sub(ordinal, text)
    text = _LEADING_ZERO_RE.sub(leading_zero, text)
    text = _EN_CARDINAL_RE.sub(cardinal, text)
    return text
