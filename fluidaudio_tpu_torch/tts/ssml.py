"""SSML processing: tag parsing + say-as interpretation.

Behavioral parity: reference `TTS/SSML/` —
- `SSMLTagParser.swift`: regex parse of <phoneme>/<sub>/<say-as>, reverse
  document order for safe in-place replacement; malformed tags (no closing
  tag, missing required attribute) do not match and pass through verbatim.
- `SSMLProcessor.swift`: `process` returns cleaned text + `<phoneme>`
  pronunciation overrides with 0-based word indices.
- `SayAsInterpreter.swift`: characters/spell-out, cardinal/number, ordinal,
  digits, date (mdy/dmy/ymd/md/dm/y/m/d), time (duration 1'21" and clock
  2:30), telephone, fraction (halves/quarters/ordinal plurals, mixed).

This module additionally keeps the segment-based `SSMLProcessor.process`
(break/prosody support) used by the synthesis managers.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass, field

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand"),
           (100, "hundred")]

DIGIT_WORDS = _ONES[:10]

_ORDINAL_WORDS = {
    1: "first", 2: "second", 3: "third", 4: "fourth", 5: "fifth",
    6: "sixth", 7: "seventh", 8: "eighth", 9: "ninth", 10: "tenth",
    11: "eleventh", 12: "twelfth", 13: "thirteenth", 14: "fourteenth",
    15: "fifteenth", 16: "sixteenth", 17: "seventeenth", 18: "eighteenth",
    19: "nineteenth",
}

_MONTH_NAMES = ["", "January", "February", "March", "April", "May", "June",
                "July", "August", "September", "October", "November",
                "December"]


def spell_out_number(n: int) -> str:
    """en_US spell-out with hyphenated tens-units ("twenty-three"),
    matching the reference's NumberFormatter.spellOut output."""
    if n < 0:
        return "minus " + spell_out_number(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + (f"-{_ONES[rem]}" if rem else "")
    for scale, name in _SCALES:
        if n >= scale:
            major, rem = divmod(n, scale)
            out = spell_out_number(major) + " " + name
            if rem:
                out += " " + spell_out_number(rem)
            return out
    return str(n)


def _ordinal_word(n: int) -> str:
    """Ordinal with teen handling and suffix rules (ref SayAsInterpreter
    `ordinalWord`/`addOrdinalSuffix`)."""
    if n in _ORDINAL_WORDS:
        return _ORDINAL_WORDS[n]
    spelled = spell_out_number(n)
    last_two = n % 100
    if 11 <= last_two <= 13:
        for suffix, repl in (("one", "eleventh"), ("two", "twelfth"),
                             ("three", "thirteenth")):
            if spelled.endswith(suffix):
                return spelled[: -len(suffix)] + repl
    last = n % 10
    replacements = {
        1: ("one", "first"), 2: ("two", "second"), 3: ("three", "third"),
        5: ("five", "fifth"), 8: ("eight", "eighth"), 9: ("nine", "ninth"),
    }
    if last in replacements:
        suffix, repl = replacements[last]
        if spelled.endswith(suffix):
            return spelled[: -len(suffix)] + repl
    if last == 0 and spelled.endswith("y"):
        return spelled[:-1] + "ieth"
    return spelled + "th"


# ------------------------------------------------------------- say-as


def interpret_say_as(text: str, interpret_as: str, fmt: str | None = "") -> str:
    """SayAsInterpreter.interpret parity (ref `SayAsInterpreter.swift:41-66`)."""
    key = (interpret_as or "").lower().strip()
    content = text.strip()
    if key in ("characters", "spell-out"):
        return " ".join(content)
    if key in ("cardinal", "number"):
        return _interpret_cardinal(content)
    if key == "ordinal":
        digits = "".join(c for c in content if c.isdigit())
        if not digits:
            return content
        return _ordinal_word(int(digits))
    if key == "digits":
        return _interpret_digits(content)
    if key == "date":
        return _interpret_date(content, fmt)
    if key == "time":
        return _interpret_time(content)
    if key == "telephone":
        return _interpret_digits("".join(c for c in content if c.isdigit()))
    if key == "fraction":
        return _interpret_fraction(content)
    return text


def _interpret_cardinal(content: str) -> str:
    filtered = "".join(c for c in content if c.isdigit() or c == "-")
    try:
        return spell_out_number(int(filtered))
    except ValueError:
        return content


def _interpret_digits(content: str) -> str:
    return " ".join(DIGIT_WORDS[int(c)] for c in content if c.isdigit())


def _interpret_date(content: str, fmt: str | None) -> str:
    components = [int(m) for m in re.findall(r"\d+", content)]
    if not components:
        return content
    result = _format_date(components, (fmt or "mdy").lower())
    return result if result else content


def _format_date(components: list[int], fmt: str) -> str:
    """ref `SayAsInterpreter.formatDate` — empty string on invalid month."""
    out: list[str] = []
    if fmt == "mdy" and len(components) >= 3:
        m, d, y = components[:3]
        if not 1 <= m <= 12:
            return ""
        out = [_MONTH_NAMES[m], _ordinal_word(d), _interpret_year(y)]
    elif fmt == "dmy" and len(components) >= 3:
        d, m, y = components[:3]
        if not 1 <= m <= 12:
            return ""
        out = [_ordinal_word(d), _MONTH_NAMES[m], _interpret_year(y)]
    elif fmt == "ymd" and len(components) >= 3:
        y, m, d = components[:3]
        if not 1 <= m <= 12:
            return ""
        out = [_interpret_year(y), _MONTH_NAMES[m], _ordinal_word(d)]
    elif fmt == "md" and len(components) >= 2:
        m, d = components[:2]
        if not 1 <= m <= 12:
            return ""
        out = [_MONTH_NAMES[m], _ordinal_word(d)]
    elif fmt == "dm" and len(components) >= 2:
        d, m = components[:2]
        if not 1 <= m <= 12:
            return ""
        out = [_ordinal_word(d), _MONTH_NAMES[m]]
    elif fmt == "y" and components:
        out = [_interpret_year(components[0])]
    elif fmt == "m" and components:
        if not 1 <= components[0] <= 12:
            return ""
        out = [_MONTH_NAMES[components[0]]]
    elif fmt == "d" and components:
        out = [_ordinal_word(components[0])]
    elif fmt not in ("mdy", "dmy", "ymd", "md", "dm", "y", "m", "d"):
        return _format_date(components, "mdy")
    return " ".join(out)


def _interpret_year(year: int) -> str:
    """ref `SayAsInterpreter.interpretYear`: 2000→two thousand, 1900→
    nineteen hundred, 1905→nineteen oh five, 1985→nineteen eighty-five."""
    if 1000 <= year <= 9999:
        century, remainder = divmod(year, 100)
        if remainder == 0:
            if year == 2000:
                return "two thousand"
            return spell_out_number(century) + " hundred"
        if 2000 <= year <= 2009:
            return "two thousand " + spell_out_number(remainder)
        if 1 <= remainder <= 9:
            return f"{spell_out_number(century)} oh {spell_out_number(remainder)}"
        return f"{spell_out_number(century)} {spell_out_number(remainder)}"
    return spell_out_number(year)


def _interpret_time(content: str) -> str:
    if "'" in content or '"' in content:
        return _interpret_duration(content)
    if ":" in content:
        return _interpret_clock_time(content)
    return content


def _interpret_duration(content: str) -> str:
    minutes = seconds = 0
    m = re.search(r"(\d+)'", content)
    if m:
        minutes = int(m.group(1))
    s = re.search(r'(\d+)"', content)
    if s:
        seconds = int(s.group(1))
    parts = []
    if minutes > 0:
        parts.append(
            f"{spell_out_number(minutes)} {'minute' if minutes == 1 else 'minutes'}"
        )
    if seconds > 0:
        parts.append(
            f"{spell_out_number(seconds)} {'second' if seconds == 1 else 'seconds'}"
        )
    return " ".join(parts) if parts else content


def _interpret_clock_time(content: str) -> str:
    try:
        components = [int(p.strip()) for p in content.split(":")]
    except ValueError:
        return content
    if len(components) < 2:
        return content
    hours, minutes = components[0], components[1]
    if minutes == 0:
        return f"{spell_out_number(hours)} o'clock"
    if 1 <= minutes <= 9:
        return f"{spell_out_number(hours)} oh {spell_out_number(minutes)}"
    return f"{spell_out_number(hours)} {spell_out_number(minutes)}"


def _interpret_fraction(content: str) -> str:
    normalized = content.replace("+", " ")
    parts = normalized.split()
    if len(parts) == 2:
        try:
            whole = int(parts[0])
        except ValueError:
            whole = None
        if whole is not None:
            frac = _parse_fraction_part(parts[1])
            if frac is not None:
                return f"{_interpret_cardinal(str(whole))} and {frac}"
    frac = _parse_fraction_part(content)
    return frac if frac is not None else content


def _parse_fraction_part(content: str) -> str | None:
    parts = content.split("/")
    if len(parts) != 2:
        return None
    try:
        num, den = int(parts[0].strip()), int(parts[1].strip())
    except ValueError:
        return None
    if den <= 0:
        return None
    if den == 2:
        return "one half" if num == 1 else f"{spell_out_number(num)} halves"
    if den == 4:
        return "one quarter" if num == 1 else f"{spell_out_number(num)} quarters"
    den_word = _ordinal_word(den)
    if num != 1:
        den_word += "s"
    return f"{spell_out_number(num)} {den_word}"


# -------------------------------------------- phoneme-override processing

_APOSTROPHES = {"'", "’", "ʼ", "‛", "‵", "′"}


def _is_word_character(c: str) -> bool:
    return (
        c.isalpha()
        or c.isdigit()
        or c in _APOSTROPHES
        or unicodedata.category(c) == "So"  # emoji & symbols
    )


def _count_words_before(text: str, index: int) -> int:
    """Completed words before `index` (ref SSMLProcessor :69-87)."""
    count, in_word = 0, False
    for c in text[:index]:
        if _is_word_character(c):
            in_word = True
        elif in_word:
            count += 1
            in_word = False
    return count


def _tokenize_phonemes(ph: str) -> list[str]:
    trimmed = ph.strip()
    if " " in trimmed:
        return trimmed.split(" ")
    return [trimmed]


@dataclass(frozen=True)
class TtsPhoneticOverride:
    word_index: int
    tokens: list[str]
    scalar_tokens: list[str]
    raw: str
    word: str


@dataclass(frozen=True)
class SSMLProcessingResult:
    text: str
    phonetic_overrides: list[TtsPhoneticOverride]


_ATTR_VALUE = r"[\"']([^\"']*)[\"']"

_PHONEME_RE = re.compile(r"<phoneme\s+([^>]+)>([^<]*)</phoneme>", re.IGNORECASE)
_SUB_RE = re.compile(r"<sub\s+([^>]+)>([^<]*)</sub>", re.IGNORECASE)
_SAYAS_RE = re.compile(r"<say-as\s+([^>]+)>([^<]*)</say-as>", re.IGNORECASE)


def _extract_attribute(name: str, attributes: str) -> str | None:
    m = re.search(r"\b" + re.escape(name) + r"\s*=\s*" + _ATTR_VALUE,
                  attributes, re.IGNORECASE)
    return m.group(1) if m else None


def process_ssml(text: str) -> SSMLProcessingResult:
    """Reference `SSMLProcessor.process`: strip <phoneme>/<sub>/<say-as>
    tags, returning cleaned text + phoneme overrides by word index.
    Malformed tags pass through unchanged."""
    if "<" not in text:
        return SSMLProcessingResult(text=text, phonetic_overrides=[])

    # Collect matches of all three tag kinds, process in reverse position
    # order so earlier replacements don't shift later indices.
    tags: list[tuple[int, int, str, re.Match]] = []
    for kind, pattern in (("phoneme", _PHONEME_RE), ("sub", _SUB_RE),
                          ("sayas", _SAYAS_RE)):
        for m in pattern.finditer(text):
            tags.append((m.start(), m.end(), kind, m))
    tags.sort(key=lambda t: t[0], reverse=True)

    working = text
    overrides: list[TtsPhoneticOverride] = []
    for start, end, kind, m in tags:
        attributes, content = m.group(1), m.group(2)
        if kind == "phoneme":
            ph = _extract_attribute("ph", attributes)
            if ph is None:
                continue
            word_index = _count_words_before(working, start)
            working = working[:start] + content + working[end:]
            overrides.append(
                TtsPhoneticOverride(
                    word_index=word_index,
                    tokens=_tokenize_phonemes(ph),
                    scalar_tokens=list(ph),
                    raw=ph,
                    word=content.strip(),
                )
            )
        elif kind == "sub":
            alias = _extract_attribute("alias", attributes)
            if alias is None:
                continue
            working = working[:start] + alias + working[end:]
        else:  # say-as
            interpret_as = _extract_attribute("interpret-as", attributes)
            if interpret_as is None:
                continue
            fmt = _extract_attribute("format", attributes)
            interpreted = interpret_say_as(content, interpret_as, fmt)
            working = working[:start] + interpreted + working[end:]

    overrides.sort(key=lambda o: o.word_index)
    return SSMLProcessingResult(text=working, phonetic_overrides=overrides)


# ------------------------------------------------ segment-based processor


@dataclass
class SsmlSegment:
    text: str
    break_after_seconds: float = 0.0
    rate: float = 1.0  # prosody rate multiplier


# attribute values may be single- OR double-quoted (both are valid XML)
_TAG_RE = re.compile(
    r"<(/?)([a-zA-Z-]+)((?:\s+[a-zA-Z-]+=(?:\"[^\"]*\"|'[^']*'))*)\s*(/?)>"
)
_ATTR_RE = re.compile(r"([a-zA-Z-]+)=(?:\"([^\"]*)\"|'([^']*)')")


def _parse_time(value: str) -> float:
    value = value.strip()
    if value.endswith("ms"):
        return float(value[:-2]) / 1000.0
    if value.endswith("s"):
        return float(value[:-1])
    return 0.0


class SSMLProcessor:
    def process(self, ssml: str) -> list[SsmlSegment]:
        """Parse an SSML (or plain-text) string into synthesizable segments."""
        if "<" not in ssml:
            return [SsmlSegment(text=ssml.strip())] if ssml.strip() else []

        segments: list[SsmlSegment] = []
        current = []
        rate_stack = [1.0]
        say_as_stack: list[tuple[str, str]] = []
        sub_alias: list[str] = []
        pos = 0

        def flush(break_s: float = 0.0):
            text = "".join(current).strip()
            current.clear()
            if text or break_s:
                segments.append(SsmlSegment(text=text, break_after_seconds=break_s,
                                            rate=rate_stack[-1]))

        for m in _TAG_RE.finditer(ssml):
            chunk = ssml[pos : m.start()]
            if chunk:
                if sub_alias:
                    pass  # <sub> content ignored; alias emitted at close
                elif say_as_stack:
                    kind, fmt = say_as_stack[-1]
                    current.append(interpret_say_as(chunk, kind, fmt))
                else:
                    current.append(chunk)
            pos = m.end()
            closing, tag, attr_str, selfclose = m.groups()
            attrs = {
                am.group(1): am.group(2) if am.group(2) is not None else am.group(3)
                for am in _ATTR_RE.finditer(attr_str or "")
            }
            tag = tag.lower()
            if tag == "break":
                flush(_parse_time(attrs.get("time", "0.5s")))
            elif tag == "say-as":
                if closing:
                    if say_as_stack:
                        say_as_stack.pop()
                else:
                    say_as_stack.append(
                        (attrs.get("interpret-as", ""), attrs.get("format", ""))
                    )
            elif tag == "sub":
                if closing:
                    if sub_alias:
                        current.append(sub_alias.pop())
                else:
                    sub_alias.append(attrs.get("alias", ""))
            elif tag == "prosody":
                if closing:
                    if len(rate_stack) > 1:
                        flush()
                        rate_stack.pop()
                else:
                    flush()
                    rate_stack.append(_parse_rate(attrs.get("rate", "medium")))
            # <speak>, <emphasis>, unknown tags: text passes through

        tail = ssml[pos:]
        if tail and not sub_alias:
            current.append(tail)
        flush()
        return [s for s in segments if s.text or s.break_after_seconds]


def _parse_rate(value: str) -> float:
    named = {"x-slow": 0.6, "slow": 0.8, "medium": 1.0, "fast": 1.25, "x-fast": 1.5}
    if value in named:
        return named[value]
    if value.endswith("%"):
        try:
            return float(value[:-1]) / 100.0
        except ValueError:
            return 1.0
    try:
        return float(value)
    except ValueError:
        return 1.0
