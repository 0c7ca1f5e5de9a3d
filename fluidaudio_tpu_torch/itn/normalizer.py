"""Inverse text normalization public API.

Port of `fluidaudio_tpu/itn/normalizer.py` (reference
`ITN/TextNormalizer.swift:21,76-133`): binds the native rule engine
(`nemo_normalize`); single expression and sentence sliding-window modes.

The engine is the repo's `native/itn/itn.cpp`, built at first use by
`native/itn.py`. Where the JAX package passes text through when its cmake
library is absent, the port raises: a failed build, or a library without
the `nemo_normalize` ABI triple, is a RuntimeError. The custom-rule ABI
stays version-gated as in JAX (a library without it has no rules).
"""

from __future__ import annotations

import ctypes
import re

from fluidaudio_tpu_torch.native.itn import load_library


# Words that read either as spoken punctuation commands or as ordinary
# English (ITN/TextNormalizer.swift:30-35). Sentence-mode callers keep them
# untouched when used as natural language inside a sentence.
AMBIGUOUS_WORDS = frozenset(
    ["period", "dash", "colon", "pipe", "slash", "dot", "plus", "hash", "percent"]
)


class TextNormalizer:
    def __init__(self, language: str = "en"):
        self.language = language
        self._lib = load_library()  # builds at first use; raises on failure
        self._has_rules = False
        # the full ABI triple must be present: a version-skewed library with
        # only some symbols is an error, not a passthrough
        needed = ("nemo_normalize", "nemo_normalize_free", "nemo_normalize_supports")
        missing = [n for n in needed if not hasattr(self._lib, n)]
        if missing:
            raise RuntimeError(f"ITN library lacks {missing}")
        self._lib.nemo_normalize.restype = ctypes.c_void_p
        self._lib.nemo_normalize.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        self._lib.nemo_normalize_free.argtypes = [ctypes.c_void_p]
        self._lib.nemo_normalize_free.restype = None
        self._lib.nemo_normalize_supports.restype = ctypes.c_int
        self._lib.nemo_normalize_supports.argtypes = [ctypes.c_char_p]
        # custom-rule ABI (added later): version-gated like the reference
        rule_syms = ("nemo_add_rule", "nemo_remove_rule", "nemo_clear_rules",
                     "nemo_rule_count")
        if all(hasattr(self._lib, n) for n in rule_syms):
            self._lib.nemo_add_rule.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
            self._lib.nemo_add_rule.restype = None
            self._lib.nemo_remove_rule.restype = ctypes.c_int
            self._lib.nemo_remove_rule.argtypes = [ctypes.c_char_p]
            self._lib.nemo_clear_rules.argtypes = []
            self._lib.nemo_clear_rules.restype = None
            self._lib.nemo_rule_count.argtypes = []
            self._lib.nemo_rule_count.restype = ctypes.c_uint
            self._has_rules = True
        if hasattr(self._lib, "nemo_version"):
            self._lib.nemo_version.argtypes = []
            self._lib.nemo_version.restype = ctypes.c_char_p

    @property
    def is_native_available(self) -> bool:
        """Always True: a normalizer exists only over a loaded library."""
        return True

    def supports(self, language: str | None = None) -> bool:
        lang = (language or self.language).encode()
        return bool(self._lib.nemo_normalize_supports(lang))

    def normalize(self, text: str, language: str | None = None) -> str:
        """Single-expression normalization (the engine's NULL, an error,
        returns the text unchanged, as in JAX)."""
        if not text:
            return text
        lang = (language or self.language).encode()
        ptr = self._lib.nemo_normalize(text.encode("utf-8"), lang)
        if not ptr:
            return text
        try:
            return ctypes.string_at(ptr).decode("utf-8")
        finally:
            self._lib.nemo_normalize_free(ptr)

    def normalize_sentences(self, text: str, language: str | None = None) -> str:
        """Sentence sliding-window mode: normalize sentence by sentence so one
        bad span cannot corrupt the whole transcript. Ambiguous punctuation
        words used as natural language are preserved
        (`TextNormalizer.normalizeSentence`)."""
        if not text:
            return text
        parts = re.split(r"(?<=[.!?])\s+", text)
        return " ".join(
            self.normalize(self.filter_ambiguous_words(p), language) for p in parts
        )

    @staticmethod
    def filter_ambiguous_words(text: str) -> str:
        """Sentence-context pass over `AMBIGUOUS_WORDS`
        (`TextNormalizer.filterAmbiguousWords`, ITN/TextNormalizer.swift:314-369):
        a word like "period" inside a multi-word sentence is natural language
        and must reach the normalizer unchanged; standalone usage is a
        punctuation command. Both outcomes currently keep the original word —
        the reference's NLTagger branch does the same — so this is the
        stable hook where a POS model can slot in without an API change."""
        return text

    # ----------------------------------------------------------- custom rules

    def add_rule(self, spoken: str, written: str) -> None:
        """Register a custom spoken->written rule (highest priority, matched
        case-insensitively before every built-in tagger)
        (`TextNormalizer.addRule`)."""
        if self._has_rules:
            self._lib.nemo_add_rule(spoken.encode("utf-8"), written.encode("utf-8"))

    def remove_rule(self, spoken: str) -> bool:
        """Remove a custom rule; True when it existed
        (`TextNormalizer.removeRule`)."""
        if not self._has_rules:
            return False
        return bool(self._lib.nemo_remove_rule(spoken.encode("utf-8")))

    def clear_rules(self) -> None:
        """Drop every custom rule (`TextNormalizer.clearRules`)."""
        if self._has_rules:
            self._lib.nemo_clear_rules()

    @property
    def rule_count(self) -> int:
        """Number of registered custom rules (`TextNormalizer.ruleCount`)."""
        return int(self._lib.nemo_rule_count()) if self._has_rules else 0

    @property
    def version(self) -> str | None:
        """Native library version, None when unavailable
        (`TextNormalizer.version`)."""
        if not hasattr(self._lib, "nemo_version"):
            return None
        raw = self._lib.nemo_version()
        return raw.decode("utf-8") if raw else None
