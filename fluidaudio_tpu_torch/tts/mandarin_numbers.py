"""Mandarin number / date / time / currency verbalization pre-pass.

Behavioral parity: reference
`TTS/KokoroAne/G2P/Mandarin/MandarinNumberNormalizer.swift` (mirroring
misaki `zh/num.py`): runs before segmentation so Arabic numerals, dates,
times, percentages, fractions, and currency become Hanzi the G2P pipeline
can speak. Rule ordering is significant — date/time/currency run before
the generic decimal/integer fallthrough.

Out of scope like the reference: scientific notation, English ordinals,
unit abbreviations, phone-number grouping.

A copy of the JAX package's module of the same name (host code).
"""

from __future__ import annotations

import re
from typing import Callable

_DIGITS = "零一二三四五六七八九"
_GROUP_UNITS = ["", "万", "亿", "兆"]


def mandarin_cardinal(n: int) -> str:
    """Non-negative integers up to ~10^16; larger degrade to digit-by-digit.
    Standalone 10..19 collapse to 十X; intra-number tens render 一十X."""
    if n == 0:
        return "零"
    if n < 0:
        return "负" + mandarin_cardinal(-n)
    groups: list[int] = []
    x = n
    while x > 0:
        groups.append(x % 10_000)
        x //= 10_000
    if len(groups) > len(_GROUP_UNITS):
        return mandarin_digit_string(str(n))
    result = ""
    emitted = False
    for i in range(len(groups) - 1, -1, -1):
        g = groups[i]
        if g == 0:
            continue
        if emitted and g < 1000:
            result += "零"
        result += _four_digit_chunk(g, is_highest=not emitted)
        result += _GROUP_UNITS[i]
        emitted = True
    return result


def _four_digit_chunk(n: int, is_highest: bool) -> str:
    if n == 0:
        return ""
    q, h, t, u = n // 1000, (n // 100) % 10, (n // 10) % 10, n % 10
    result = ""
    pending_zero = False
    if q > 0:
        result += _DIGITS[q] + "千"
    if h > 0:
        if pending_zero:
            result += "零"
            pending_zero = False
        result += _DIGITS[h] + "百"
    elif q > 0 and (t > 0 or u > 0):
        pending_zero = True
    if t > 0:
        if pending_zero:
            result += "零"
            pending_zero = False
        if t == 1 and q == 0 and h == 0 and is_highest:
            result += "十"
        else:
            result += _DIGITS[t] + "十"
    elif (q > 0 or h > 0) and u > 0:
        pending_zero = True
    if u > 0:
        if pending_zero:
            result += "零"
        result += _DIGITS[u]
    return result


def mandarin_digit_string(s: str) -> str:
    """'2025' -> '二零二五' (years, out-of-range fallback)."""
    out = []
    for ch in s:
        if ch.isdigit():
            out.append(_DIGITS[int(ch)])
        elif ch == "-":
            out.append("负")
        elif ch == ".":
            out.append("点")
    return "".join(out)


def mandarin_decimal(s: str) -> str:
    """'3.14' -> '三点一四'; trailing fractional zeros stripped (5.50->五点五)."""
    parts = s.split(".", 1)
    int_part = parts[0]
    try:
        int_str = mandarin_cardinal(int(int_part))
    except ValueError:
        int_str = mandarin_digit_string(int_part)
    if len(parts) == 1:
        return int_str
    frac = parts[1]
    while len(frac) > 1 and frac.endswith("0"):
        frac = frac[:-1]
    if not frac or frac == "0":
        return int_str
    return int_str + "点" + mandarin_digit_string(frac)


def _int_to_hanzi(s: str) -> str:
    try:
        return mandarin_cardinal(int(s))
    except ValueError:
        return s


_PIPELINE: list[tuple[re.Pattern, Callable[[re.Match], str]]] = [
    # Date: 2025年5月3日 / 2025年5月3号
    (re.compile(r"(\d{4})年(\d{1,2})月(\d{1,2})[日号]"),
     lambda m: mandarin_digit_string(m.group(1)) + "年" + _int_to_hanzi(m.group(2))
     + "月" + _int_to_hanzi(m.group(3)) + "日"),
    # Date: 2025年5月
    (re.compile(r"(\d{4})年(\d{1,2})月"),
     lambda m: mandarin_digit_string(m.group(1)) + "年" + _int_to_hanzi(m.group(2)) + "月"),
    # Date: 2025-05-03 / 2025/05/03
    (re.compile(r"(\d{4})[-/](\d{1,2})[-/](\d{1,2})\b"),
     lambda m: mandarin_digit_string(m.group(1)) + "年" + _int_to_hanzi(m.group(2))
     + "月" + _int_to_hanzi(m.group(3)) + "日"),
    # Date: 2025年 (year-only)
    (re.compile(r"(\d{4})年"), lambda m: mandarin_digit_string(m.group(1)) + "年"),
    # Time: HH:MM:SS
    (re.compile(r"(\d{1,2}):(\d{2}):(\d{2})"),
     lambda m: _int_to_hanzi(m.group(1)) + "点" + _int_to_hanzi(m.group(2))
     + "分" + _int_to_hanzi(m.group(3)) + "秒"),
    # Time: HH:MM
    (re.compile(r"(\d{1,2}):(\d{2})"),
     lambda m: _int_to_hanzi(m.group(1)) + "点" + _int_to_hanzi(m.group(2)) + "分"),
    # Currency: prefix symbol + amount.
    (re.compile(r"[¥￥](\d+(?:\.\d+)?)"), lambda m: mandarin_decimal(m.group(1)) + "元"),
    (re.compile(r"\$(\d+(?:\.\d+)?)"), lambda m: mandarin_decimal(m.group(1)) + "美元"),
    (re.compile(r"€(\d+(?:\.\d+)?)"), lambda m: mandarin_decimal(m.group(1)) + "欧元"),
    (re.compile(r"£(\d+(?:\.\d+)?)"), lambda m: mandarin_decimal(m.group(1)) + "英镑"),
    # Percentage: 99% / 0.5%
    (re.compile(r"(\d+(?:\.\d+)?)%"), lambda m: "百分之" + mandarin_decimal(m.group(1))),
    # Fraction: a/b — denominator first (二分之一 for 1/2).
    (re.compile(r"(\d+)/(\d+)"),
     lambda m: _int_to_hanzi(m.group(2)) + "分之" + _int_to_hanzi(m.group(1))),
    # Plain decimal (what currency/percentage didn't catch).
    (re.compile(r"\d+\.\d+"), lambda m: mandarin_decimal(m.group(0))),
    # Plain integer fallthrough.
    (re.compile(r"\d+"), lambda m: _int_to_hanzi(m.group(0))),
]


def mandarin_normalize_numbers(text: str) -> str:
    """Convert every numeric expression in `text` to Hanzi verbalization."""
    for pattern, transform in _PIPELINE:
        text = pattern.sub(transform, text)
    return text
