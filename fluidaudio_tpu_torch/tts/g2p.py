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

A copy of the JAX package's `tts/g2p.py`, with the BART fallback and
`MultilingualG2P` (over the ByT5 / seq2seq G2P models) on a torch device.
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

    from fluidaudio_tpu_torch.convert.bart import config_from_hf
    from fluidaudio_tpu_torch.models.bart_g2p import BartG2P, bart_greedy_decode
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


class MultilingualG2P:
    """Batched multilingual word phonemizer over the byte-level seq2seq.

    Behavioral parity: reference `G2P/MultilingualG2PModel.swift:9`
    (ByT5 CharsiuG2P actor singleton with per-language prompts + result
    cache). The words not cached go to the device as one batch for one
    greedy decode (no host read per token); phoneme ids map to IPA
    codepoints via the model's output table. Without trained weights
    (registry cache empty) outputs are untrained-model noise — the API,
    batching, and caching layers are what this class pins down.

    `params`: a flax parameter tree of the compact seq2seq (numpy), loaded
    through `utils/weights.py`; None draws seeded random weights on `device`
    (None = the GPU). A converted ByT5 checkpoint (`byt5.npz` + HF
    `config.json` in `checkpoint_dir`, or the model cache's CharsiuG2P
    folder when it is None) takes precedence.
    """

    def __init__(self, params=None, rng_seed: int = 0,
                 checkpoint_dir: str | Path | None = None, device=None):
        import torch

        from fluidaudio_tpu_torch.models.g2p_seq2seq import G2P_BASE, G2pSeq2Seq
        from fluidaudio_tpu_torch.models.zoo import random_init_
        from fluidaudio_tpu_torch.utils.device import resolve_device
        from fluidaudio_tpu_torch.utils.weights import from_jax_params, load_npz, load_state

        self.device = resolve_device(device)
        # real CharsiuG2P ByT5 weights when converted + cached; otherwise
        # the compact seq2seq with seeded random init keeps the API live.
        self.byt5 = None
        base = Path(checkpoint_dir) if checkpoint_dir else None
        if base is None:
            from fluidaudio_tpu_torch.registry import DownloadUtils, Repo

            base = DownloadUtils.repo_dir(Repo.CHARSIU_G2P)
        ckpt = base / "byt5.npz"
        cfg_json = base / "config.json"
        if ckpt.exists() and cfg_json.exists():
            from fluidaudio_tpu_torch.convert.byt5 import config_from_hf
            from fluidaudio_tpu_torch.models.byt5_g2p import ByT5G2P

            self.byt5 = ByT5G2P(config_from_hf(json.loads(cfg_json.read_text())),
                                device=self.device).eval()
            load_state(self.byt5, load_npz(ckpt))

        self.model = None
        if params is not None or self.byt5 is None:
            self.model = G2pSeq2Seq(G2P_BASE, device=self.device).eval()
            if params is None:
                random_init_(self.model, torch.Generator(device=self.device).manual_seed(rng_seed))
            else:
                load_state(self.model, from_jax_params(params))
        self._cache: dict[tuple[str, str], str] = {}

    # phoneme id -> IPA char: ids 3.. map to a compact IPA codepoint table
    _IPA_TABLE = (
        "abcdefghijklmnopqrstuvwxyz"
        "æɑɒɔəɚɛɜɝɪɨʊʉʌʏøœɶɐɯɤeiouy"
        "ŋɲɳɴʃʒʂʐɕʑçʝxɣχʁħʕhɦθðszfvɸβ"
        "pbtdkɡqɢʔmɱnɾrʀʙlɫʎʟjwɥɹɻˈˌːˑ̃"
    )

    def _ids_to_ipa(self, ids) -> str:
        from fluidaudio_tpu_torch.models.g2p_seq2seq import BOS, EOS, PAD

        out = []
        for i in ids:
            i = int(i)
            if i in (BOS, PAD):
                continue
            if i == EOS:
                break
            idx = i - 3
            if 0 <= idx < len(self._IPA_TABLE):
                out.append(self._IPA_TABLE[idx])
        return "".join(out)

    def decode_ids(self, words: list[str], language: str = "eng-us"):
        """The model's greedy token ids for `words` (one device batch, one
        copy back): ByT5 -> [n, 48]; the compact seq2seq -> [n, 48] with
        the BOS in column 0."""
        import numpy as np
        import torch

        if self.byt5 is not None:
            from fluidaudio_tpu_torch.models.byt5_g2p import byt5_greedy_decode, encode_bytes

            # CharsiuG2P prompt format: "<lang>: word"
            max_len = max(len(f"<{language}>: {w}".encode()) for w in words) + 2
            rows = np.stack([encode_bytes(f"<{language}>: {w}", max_len)[0] for w in words])
            enc = torch.as_tensor(rows, dtype=torch.int64, device=self.device)
            return byt5_greedy_decode(self.byt5, enc, enc != 0).cpu().numpy()
        from fluidaudio_tpu_torch.models.g2p_seq2seq import encode_word, g2p_greedy_decode

        rows, lens = zip(*(encode_word(w, language_prefix=G2P_LANGUAGES[language])
                           for w in words))
        tokens, _ = g2p_greedy_decode(
            self.model, torch.as_tensor(np.stack(rows), dtype=torch.int64, device=self.device),
            torch.as_tensor(np.array(lens), dtype=torch.int64, device=self.device))
        return tokens.cpu().numpy()

    def phonemize_words(self, words: list[str], language: str = "eng-us") -> list[str]:
        """Batch-phonemize; per-(word, language) results are cached."""
        if G2P_LANGUAGES.get(language) is None:
            raise ValueError(f"unknown G2P language {language!r}; "
                             f"see G2P_LANGUAGES ({len(G2P_LANGUAGES)} codes)")
        todo = [w for w in words if (w, language) not in self._cache]
        if todo:
            out = self.decode_ids(todo, language)
            if self.byt5 is not None:
                from fluidaudio_tpu_torch.models.byt5_g2p import decode_bytes

                texts = [decode_bytes(row) for row in out]
            else:
                texts = [self._ids_to_ipa(row) for row in out]
            for w, t in zip(todo, texts):
                self._cache[(w, language)] = t
        return [self._cache[(w, language)] for w in words]

    def phonemize(self, text: str, language: str = "eng-us") -> str:
        import re

        words = [w for w in re.split(r"[^\w']+", text.lower()) if w]
        return " ".join(self.phonemize_words(words, language))
