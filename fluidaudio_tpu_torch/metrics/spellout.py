"""Digit -> spelled-out cardinal conversion for multilingual WER scoring.

Scoring-side ITN: NVIDIA's multilingual FLEURS pipeline (and the reference's
`NemotronMultilingualFleursBenchmark.swift:100-113` via NumberFormatter
.spellOut) spells digits out IN THE REFERENCE TEXT so a model that says
"mille neuf cent soixante-seize" isn't penalized against the literal "1976"
— without this, the ~22-25% of FLEURS samples containing digits dominate
the error count. Supported: fr, de, es, it, pt (the reference's
`fleursToSpellOutLocale` set). Output is lowercase and hyphen-free (the
basic normalizer folds hyphens to spaces anyway).
"""

from __future__ import annotations

import re

# --------------------------------------------------------------------- fr

_FR_UNITS = ["zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept",
             "huit", "neuf", "dix", "onze", "douze", "treize", "quatorze",
             "quinze", "seize", "dix sept", "dix huit", "dix neuf"]
_FR_TENS = {20: "vingt", 30: "trente", 40: "quarante", 50: "cinquante",
            60: "soixante"}


def _fr_under_100(n: int) -> str:
    if n < 20:
        return _FR_UNITS[n]
    if n < 70:
        t, u = divmod(n, 10)
        base = _FR_TENS[t * 10]
        if u == 0:
            return base
        if u == 1:
            return f"{base} et un"
        return f"{base} {_FR_UNITS[u]}"
    if n < 80:  # soixante-dix .. soixante-dix-neuf
        if n == 71:
            return "soixante et onze"
        return f"soixante {_FR_UNITS[n - 60]}"
    # 80-99
    if n == 80:
        return "quatre vingts"
    return f"quatre vingt {_FR_UNITS[n - 80]}"


def _fr_under_1000(n: int) -> str:
    h, r = divmod(n, 100)
    if h == 0:
        return _fr_under_100(r)
    if h == 1:
        head = "cent"
    else:
        head = f"{_FR_UNITS[h]} cent"
        if r == 0:
            head += "s"  # deux cents
    return head if r == 0 else f"{head} {_fr_under_100(r)}"


def _fr(n: int) -> str:
    parts = []
    for scale, one, many in ((10**9, "un milliard", "milliards"),
                             (10**6, "un million", "millions")):
        if n >= scale:
            q, n = divmod(n, scale)
            parts.append(one if q == 1 else f"{_fr_under_1000(q)} {many}")
    if n >= 1000:
        q, n = divmod(n, 1000)
        parts.append("mille" if q == 1 else f"{_fr_under_1000(q)} mille")
    if n or not parts:
        parts.append(_fr_under_1000(n))
    return " ".join(parts)


# --------------------------------------------------------------------- de

_DE_UNITS = ["null", "eins", "zwei", "drei", "vier", "fünf", "sechs",
             "sieben", "acht", "neun", "zehn", "elf", "zwölf", "dreizehn",
             "vierzehn", "fünfzehn", "sechzehn", "siebzehn", "achtzehn",
             "neunzehn"]
_DE_TENS = {20: "zwanzig", 30: "dreißig", 40: "vierzig", 50: "fünfzig",
            60: "sechzig", 70: "siebzig", 80: "achtzig", 90: "neunzig"}


def _de_under_100(n: int, final: bool) -> str:
    """final=True -> standalone 'eins'; inside a larger number -> 'ein'."""
    if n < 20:
        if n == 1:
            return "eins" if final else "ein"
        return _DE_UNITS[n]
    t, u = divmod(n, 10)
    tens = _DE_TENS[t * 10]
    if u == 0:
        return tens
    unit = "ein" if u == 1 else _DE_UNITS[u]
    return f"{unit}und{tens}"


def _de_under_1000(n: int, final: bool) -> str:
    h, r = divmod(n, 100)
    out = ""
    if h:
        out += ("ein" if h == 1 else _DE_UNITS[h]) + "hundert"
    if r:
        out += _de_under_100(r, final)
    return out or "null"


def _de(n: int) -> str:
    if n == 0:
        return "null"
    words = []
    if n >= 10**9:
        q, n = divmod(n, 10**9)
        words.append("eine milliarde" if q == 1
                     else f"{_de_under_1000(q, False)} milliarden")
    if n >= 10**6:
        q, n = divmod(n, 10**6)
        words.append("eine million" if q == 1
                     else f"{_de_under_1000(q, False)} millionen")
    tail = ""
    if n >= 1000:
        q, n = divmod(n, 1000)
        tail += _de_under_1000(q, False) + "tausend"
    if n:
        tail += _de_under_1000(n, True)
    if tail:
        words.append(tail)
    return " ".join(words)


# --------------------------------------------------------------------- es

_ES_UNITS = ["cero", "uno", "dos", "tres", "cuatro", "cinco", "seis",
             "siete", "ocho", "nueve", "diez", "once", "doce", "trece",
             "catorce", "quince", "dieciséis", "diecisiete", "dieciocho",
             "diecinueve"]
_ES_TWENTIES = ["veinte", "veintiuno", "veintidós", "veintitrés",
                "veinticuatro", "veinticinco", "veintiséis", "veintisiete",
                "veintiocho", "veintinueve"]
_ES_TENS = {30: "treinta", 40: "cuarenta", 50: "cincuenta", 60: "sesenta",
            70: "setenta", 80: "ochenta", 90: "noventa"}
_ES_HUNDREDS = {1: "ciento", 2: "doscientos", 3: "trescientos",
                4: "cuatrocientos", 5: "quinientos", 6: "seiscientos",
                7: "setecientos", 8: "ochocientos", 9: "novecientos"}


def _es_under_100(n: int) -> str:
    if n < 20:
        return _ES_UNITS[n]
    if n < 30:
        return _ES_TWENTIES[n - 20]
    t, u = divmod(n, 10)
    tens = _ES_TENS[t * 10]
    return tens if u == 0 else f"{tens} y {_ES_UNITS[u]}"


def _es_under_1000(n: int) -> str:
    if n == 100:
        return "cien"
    h, r = divmod(n, 100)
    if h == 0:
        return _es_under_100(r)
    head = _ES_HUNDREDS[h]
    return head if r == 0 else f"{head} {_es_under_100(r)}"


def _es(n: int) -> str:
    parts = []
    if n >= 10**9:
        q, n = divmod(n, 10**9)
        parts.append("mil millones" if q == 1
                     else f"{_es_under_1000(q)} mil millones")
    if n >= 10**6:
        q, n = divmod(n, 10**6)
        parts.append("un millón" if q == 1 else f"{_es_under_1000(q)} millones")
    if n >= 1000:
        q, n = divmod(n, 1000)
        parts.append("mil" if q == 1 else f"{_es_under_1000(q)} mil")
    if n or not parts:
        parts.append(_es_under_1000(n))
    return " ".join(parts)


# --------------------------------------------------------------------- it

_IT_UNITS = ["zero", "uno", "due", "tre", "quattro", "cinque", "sei",
             "sette", "otto", "nove", "dieci", "undici", "dodici", "tredici",
             "quattordici", "quindici", "sedici", "diciassette", "diciotto",
             "diciannove"]
_IT_TENS = {20: "venti", 30: "trenta", 40: "quaranta", 50: "cinquanta",
            60: "sessanta", 70: "settanta", 80: "ottanta", 90: "novanta"}


def _it_under_100(n: int) -> str:
    if n < 20:
        return _IT_UNITS[n]
    t, u = divmod(n, 10)
    tens = _IT_TENS[t * 10]
    if u == 0:
        return tens
    if u in (1, 8):  # elision: ventuno, ventotto
        tens = tens[:-1]
    unit = "tré" if u == 3 else _IT_UNITS[u]  # ventitré
    return tens + unit


def _it_under_1000(n: int) -> str:
    h, r = divmod(n, 100)
    out = ""
    if h:
        out = ("" if h == 1 else _IT_UNITS[h]) + "cento"
        if r and 80 <= r < 90:  # centottanta elision
            out = out[:-1]
    return out + (_it_under_100(r) if r else "")


def _it(n: int) -> str:
    if n == 0:
        return "zero"
    parts = []
    if n >= 10**9:
        q, n = divmod(n, 10**9)
        parts.append("un miliardo" if q == 1
                     else f"{_it_under_1000(q)} miliardi")
    if n >= 10**6:
        q, n = divmod(n, 10**6)
        parts.append("un milione" if q == 1
                     else f"{_it_under_1000(q)} milioni")
    tail = ""
    if n >= 1000:
        q, n = divmod(n, 1000)
        tail = "mille" if q == 1 else _it_under_1000(q) + "mila"
    if n:
        tail += _it_under_1000(n)
    if tail:
        parts.append(tail)
    return " ".join(parts)


# --------------------------------------------------------------------- pt

_PT_UNITS = ["zero", "um", "dois", "três", "quatro", "cinco", "seis",
             "sete", "oito", "nove", "dez", "onze", "doze", "treze",
             "quatorze", "quinze", "dezesseis", "dezessete", "dezoito",
             "dezenove"]
_PT_TENS = {20: "vinte", 30: "trinta", 40: "quarenta", 50: "cinquenta",
            60: "sessenta", 70: "setenta", 80: "oitenta", 90: "noventa"}
_PT_HUNDREDS = {1: "cento", 2: "duzentos", 3: "trezentos", 4: "quatrocentos",
                5: "quinhentos", 6: "seiscentos", 7: "setecentos",
                8: "oitocentos", 9: "novecentos"}


def _pt_under_100(n: int) -> str:
    if n < 20:
        return _PT_UNITS[n]
    t, u = divmod(n, 10)
    tens = _PT_TENS[t * 10]
    return tens if u == 0 else f"{tens} e {_PT_UNITS[u]}"


def _pt_under_1000(n: int) -> str:
    if n == 100:
        return "cem"
    h, r = divmod(n, 100)
    if h == 0:
        return _pt_under_100(r)
    head = _PT_HUNDREDS[h]
    return head if r == 0 else f"{head} e {_pt_under_100(r)}"


def _pt(n: int) -> str:
    parts = []
    if n >= 10**9:
        q, n = divmod(n, 10**9)
        parts.append("um bilhão" if q == 1 else f"{_pt_under_1000(q)} bilhões")
    if n >= 10**6:
        q, n = divmod(n, 10**6)
        parts.append("um milhão" if q == 1 else f"{_pt_under_1000(q)} milhões")
    if n >= 1000:
        q, n = divmod(n, 1000)
        parts.append("mil" if q == 1 else f"{_pt_under_1000(q)} mil")
    if n or not parts:
        # "e" before a final group that is <100 or an exact hundred
        if parts and (n < 100 or n % 100 == 0):
            parts.append(f"e {_pt_under_1000(n)}")
        else:
            parts.append(_pt_under_1000(n))
    return " ".join(parts)


_SPELLERS = {"fr": _fr, "de": _de, "es": _es, "it": _it, "pt": _pt}

SUPPORTED_LANGUAGES = frozenset(_SPELLERS)


def spell_out_number(n: int, lang: str) -> str:
    """Cardinal spelling of a non-negative integer in `lang` (iso-639-1)."""
    speller = _SPELLERS.get(lang.split("_")[0].split("-")[0].lower())
    if speller is None:
        raise ValueError(f"no speller for language {lang!r}")
    if n < 0:
        raise ValueError("negative numbers not supported")
    return speller(int(n))


_NUM_RE = re.compile(r"\d+")


def spell_out_numbers(text: str, lang: str | None) -> str:
    """Replace every standalone digit run in `text` with its spelling.

    `lang=None` (or an unsupported language) returns the text unchanged —
    mirrors `fleursToSpellOutLocale` returning nil for en/CJK."""
    if lang is None:
        return text
    key = lang.split("_")[0].split("-")[0].lower()
    if key not in _SPELLERS:
        return text
    return _NUM_RE.sub(lambda m: spell_out_number(int(m.group()), key), text)
