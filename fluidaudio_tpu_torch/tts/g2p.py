"""English grapheme-to-phoneme: Misaki lexicon + rule/seq2seq fallback.

Behavioral parity: reference Kokoro G2P path
(`KokoroAne/G2P/English/KokoroAneEnglishPhonemizer.swift:7-18`) — word
resolution order:
  1. caller-supplied custom lexicon (exact spelling, then normalized)
  2. letter-name overrides for spellings whose bundled entry doesn't read
     as letter names (`AI`, `US` — issue #710)
  3. case-sensitive Misaki lexicon hit (proper nouns, `NATO`)
  4. case-sensitive hit on the normalized lower-case form
  5. lower-cased Misaki hit (weak function-word forms, issue #691)
  6. strict ASCII all-caps initialisms (2-5 letters) spelled as letter
     names after a full lexicon miss (`FBI` -> per-letter entries)
  7. per-OOV-word fallback (letter-to-sound rules here; a learned seq2seq
     — the BART analog — can be injected via `fallback=`)

The Misaki lexicon loads from the preprocessed `us_lexicon_cache.json`
shipped in the kokoro HF repo (schema `{lower: {word: [tokens]},
caseSensitive: {word: [tokens]}}`, reference
`TTS/Shared/LexiconAssetCache.swift:19-23`); absent cache degrades to the
seed lexicon + rules.

The English part of the JAX package's `tts/g2p.py`; `MultilingualG2P` (over
the ByT5 / seq2seq G2P models) is not ported yet (ROADMAP Queue A).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable

# minimal seed lexicon (IPA) — full lexicon loads from assets when cached
_SEED_LEXICON = {
    "the": "ðə", "a": "ə", "and": "ænd", "to": "tu", "of": "ʌv", "in": "ɪn",
    "is": "ɪz", "you": "ju", "that": "ðæt", "it": "ɪt", "he": "hi",
    "she": "ʃi", "was": "wʌz", "for": "fɔɹ", "are": "ɑɹ", "with": "wɪθ",
    "his": "hɪz", "they": "ðeɪ", "this": "ðɪs", "have": "hæv", "be": "bi",
    "not": "nɑt", "hello": "həˈloʊ", "world": "wɝld", "speech": "spitʃ",
    "test": "tɛst", "audio": "ˈɔdioʊ", "one": "wʌn", "two": "tu",
    "three": "θɹi", "four": "fɔɹ", "five": "faɪv",
}

# letter-to-sound fallback rules (digraphs first, longest match wins)
_RULES = [
    ("tion", "ʃən"), ("ough", "oʊ"), ("igh", "aɪ"), ("tch", "tʃ"),
    ("ch", "tʃ"), ("sh", "ʃ"), ("th", "θ"), ("ph", "f"), ("wh", "w"),
    ("ng", "ŋ"), ("ck", "k"), ("qu", "kw"), ("ee", "i"), ("oo", "u"),
    ("ea", "i"), ("ai", "eɪ"), ("ay", "eɪ"), ("ou", "aʊ"), ("ow", "oʊ"),
    ("oi", "ɔɪ"), ("oy", "ɔɪ"), ("ar", "ɑɹ"), ("er", "ɝ"), ("ir", "ɝ"),
    ("or", "ɔɹ"), ("ur", "ɝ"),
    ("a", "æ"), ("b", "b"), ("c", "k"), ("d", "d"), ("e", "ɛ"), ("f", "f"),
    ("g", "ɡ"), ("h", "h"), ("i", "ɪ"), ("j", "dʒ"), ("k", "k"), ("l", "l"),
    ("m", "m"), ("n", "n"), ("o", "ɑ"), ("p", "p"), ("r", "ɹ"), ("s", "s"),
    ("t", "t"), ("u", "ʌ"), ("v", "v"), ("w", "w"), ("x", "ks"),
    ("y", "j"), ("z", "z"),
]


# exact uppercase spellings whose lexicon entry is not the letter-name
# reading callers expect (reference EnglishInitialisms.letterNameOverrides)
_LETTER_NAME_OVERRIDES = {"AI", "US"}
_INITIALISM_LEN = range(2, 6)

_KNOWN_LEADING_APOSTROPHE = {"'cause", "'em", "'til", "'tis", "'twas", "'twere"}


def normalize_key(word: str) -> str:
    """Lowercase + keep letters/digits/apostrophes (reference
    `KokoroAneEnglishPhonemizer.normalizeKey`)."""
    return "".join(c for c in word.lower() if c.isalnum() or c == "'")


def _is_initialism(word: str) -> bool:
    return (len(word) in _INITIALISM_LEN
            and all(c.isascii() and c.isupper() and c.isalpha() for c in word))


def split_words(text: str) -> list[str]:
    """Runs of letters/digits (internal apostrophes/hyphens stay inside:
    `don't`, `twenty-one`), single punctuation chars as their own tokens
    (reference `KokoroAneEnglishPhonemizer.splitWords`)."""
    out: list[str] = []
    cur = ""
    n = len(text)
    for i, ch in enumerate(text):
        if ch.isspace():
            if cur:
                out.append(cur)
                cur = ""
        elif ch == "'":
            next_is_word = i + 1 < n and (text[i + 1].isalnum())
            if cur and next_is_word:
                cur += ch
            elif not cur and any(
                text[i : i + len(w)].lower() == w for w in _KNOWN_LEADING_APOSTROPHE
            ):
                cur += ch
            else:
                if cur:
                    out.append(cur)
                    cur = ""
                out.append(ch)
        elif ch.isalnum() or ch == "-":
            cur += ch
        else:
            if cur:
                out.append(cur)
                cur = ""
            out.append(ch)
    if cur:
        out.append(cur)
    return out


class EnglishG2P:
    def __init__(
        self,
        lexicon_path: str | Path | None = None,
        *,
        misaki_cache: str | Path | None = None,
        custom_lexicon: dict[str, str] | None = None,
        allowed_punctuation: str = ",.!?;:…\"'()-",
        fallback: Callable[[str], str | None] | None = None,
    ):
        self.lexicon = dict(_SEED_LEXICON)
        if lexicon_path and Path(lexicon_path).exists():
            self.lexicon.update(json.loads(Path(lexicon_path).read_text()))
        self.custom_lexicon = dict(custom_lexicon or {})
        self.allowed_punctuation = set(allowed_punctuation)
        self.fallback = fallback
        # Misaki maps: lower-cased word -> tokens, original-case -> tokens
        self.misaki_lower: dict[str, list[str]] = {}
        self.misaki_case: dict[str, list[str]] = {}
        if misaki_cache:
            self.load_misaki_cache(misaki_cache)

    def load_misaki_cache(
        self, path: str | Path, allowed_tokens: set[str] | None = None
    ) -> bool:
        """Load `us_lexicon_cache.json` (`{lower, caseSensitive}` schema);
        -> False when missing/unparseable (degrade to seed+rules)."""
        p = Path(path)
        if p.is_dir():
            p = p / "us_lexicon_cache.json"
        if not p.exists():
            return False
        try:
            payload = json.loads(p.read_text())
            lower = payload["lower"]
            case = payload.get("caseSensitive", {})
        except (ValueError, KeyError):
            return False
        if allowed_tokens is not None:
            lower = {w: [t for t in ts if t in allowed_tokens] for w, ts in lower.items()}
            case = {w: [t for t in ts if t in allowed_tokens] for w, ts in case.items()}
        self.misaki_lower = {w: list(ts) for w, ts in lower.items()}
        self.misaki_case = {w: list(ts) for w, ts in case.items()}
        return True

    # ------------------------------------------------------- resolution

    def _spell_letters(self, word: str) -> str | None:
        """`FBI` -> per-letter case-sensitive entries joined by spaces;
        None when any letter is missing (caller falls through)."""
        letters = []
        for ch in word:
            toks = self.misaki_case.get(ch)
            if not toks:
                return None
            letters.append("".join(toks))
        return " ".join(letters) if letters else None

    def _rules(self, w: str) -> str:
        out = []
        i = 0
        while i < len(w):
            for graph, phon in _RULES:
                if w.startswith(graph, i):
                    out.append(phon)
                    i += len(graph)
                    break
            else:
                i += 1  # drop unknown characters
        return "".join(out)

    def word_to_phonemes(self, word: str) -> str | None:
        normalized = normalize_key(word)

        custom = self.custom_lexicon.get(word) or self.custom_lexicon.get(normalized)
        if custom:
            return custom

        if word in _LETTER_NAME_OVERRIDES:
            spelled = self._spell_letters(word)
            if spelled:
                return spelled

        toks = (self.misaki_case.get(word) or self.misaki_case.get(normalized)
                or self.misaki_lower.get(normalized))
        if toks:
            return "".join(toks)

        if normalized in self.lexicon:
            return self.lexicon[normalized]

        if _is_initialism(word):
            spelled = self._spell_letters(word)
            if spelled:
                return spelled

        if not normalized:
            return None
        if self.fallback is not None:
            got = self.fallback(normalized)
            if got:
                return got
        return self._rules(normalized)

    def phonemize(self, text: str) -> str:
        """Text -> Misaki-style IPA: words joined by single spaces, kept
        punctuation attached to the preceding word.

        Raises ValueError on empty input and when no word resolves to any
        phonemes (reference KokoroAneEnglishPhonemizer `.emptyInput` /
        `.nothingResolved` throws)."""
        if not text.strip():
            raise ValueError("empty input: nothing to phonemize")
        parts: list[str] = []
        had_word = False
        for token in split_words(text.strip()):
            if not token:
                continue
            if len(token) == 1 and not token.isalnum():
                if token not in self.allowed_punctuation:
                    continue
                if parts:
                    parts[-1] += token
                else:
                    parts.append(token)
                continue
            had_word = True
            ipa = self.word_to_phonemes(token)
            if ipa:
                parts.append(ipa)
        if had_word and not parts:
            raise ValueError(f"no word in {text!r} resolved to phonemes")
        return " ".join(parts)


def load_bart_fallback(checkpoint_dir: str | Path, device=None):
    """Build the per-OOV-word BART G2P fallback when a converted checkpoint
    is cached (reference `G2P/G2PModel.swift:6`: [BOS]+graphemes+[EOS] ->
    greedy decode -> phoneme tokens via the vocab tables).

    Expects `bart.npz` (the JAX package's `convert/bart.py` output, or a
    JAX-saved `BartG2P` tree), `config.json` (HF), and `vocab.json`
    ({"grapheme_to_id": {...}, "id_to_phoneme": {...}}) in
    `checkpoint_dir`; -> callable(word) -> IPA string, or None if absent.
    The model runs on `device` (None = the GPU).
    """
    base = Path(checkpoint_dir)
    ckpt, cfg_json, vocab_json = base / "bart.npz", base / "config.json", base / "vocab.json"
    if not (ckpt.exists() and cfg_json.exists() and vocab_json.exists()):
        return None

    import torch

    from fluidaudio_tpu_torch.models.bart_g2p import BartG2P, bart_greedy_decode, config_from_hf
    from fluidaudio_tpu_torch.utils.device import resolve_device
    from fluidaudio_tpu_torch.utils.weights import load_npz, load_state

    dev = resolve_device(device)
    cfg = config_from_hf(json.loads(cfg_json.read_text()))
    vocab = json.loads(vocab_json.read_text())
    g2i = vocab["grapheme_to_id"]
    i2p = {int(k): v for k, v in vocab["id_to_phoneme"].items()}
    unk = vocab.get("unk_token_id", 3)
    model = BartG2P(cfg, device=dev).eval()
    load_state(model, load_npz(ckpt))
    cache: dict[str, str | None] = {}

    def fallback(word: str) -> str | None:
        if word in cache:
            return cache[word]
        ids = [cfg.bos_token_id] + [g2i.get(c, unk) for c in word] + [cfg.eos_token_id]
        enc = torch.tensor([ids], dtype=torch.int64, device=dev)
        out = bart_greedy_decode(model, enc, torch.ones_like(enc, dtype=torch.bool))
        phones = []
        for i in out.cpu().numpy()[0]:
            i = int(i)
            if i == cfg.eos_token_id:
                break
            if i in i2p:
                phones.append(i2p[i])
        result = "".join(phones) or None
        cache[word] = result
        return result

    return fallback


# --------------------------------------------------------------------------
# Multilingual seq2seq G2P (charsiu ByT5 analog)
# --------------------------------------------------------------------------

# language code -> prefix token offset (reference MultilingualG2PModel.swift:9
# conditions CharsiuG2P with a "<lang>: " prompt; here a learned prefix token)
G2P_LANGUAGES = {
    code: i for i, code in enumerate([
        "eng-us", "eng-uk", "fra", "deu", "spa", "ita", "por", "nld",
        "pol", "rus", "ukr", "ces", "slk", "ron", "hun", "bul", "ell",
        "tur", "ara", "heb", "hin", "ben", "tam", "tha", "vie", "ind",
        "msa", "jpn", "kor", "cmn", "yue", "swe", "nor", "dan", "fin",
        "por-bz",  # Brazilian Portuguese (kokoro pf_/pm_ voices)
    ])
}

# kokoro voice-name prefix -> charsiu language code (reference
# `MultilingualG2PLanguage.fromKokoroVoice`, MultilingualG2PModel.swift)
_KOKORO_VOICE_LANG = {
    "a": "eng-us", "b": "eng-uk", "e": "spa", "f": "fra", "h": "hin",
    "i": "ita", "j": "jpn", "p": "por-bz", "z": "cmn",
}


def kokoro_voice_to_language(voice: str) -> str | None:
    """`af_heart` -> "eng-us", `zf_xiaobei` -> "cmn"; None for unknown
    prefixes, empty, or too-short names. Voice format: `<lang><gender>_name`
    with gender in {f, m}."""
    if len(voice) < 2 or voice[1] not in ("f", "m"):
        return None
    return _KOKORO_VOICE_LANG.get(voice[0])
