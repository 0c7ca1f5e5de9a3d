"""Custom vocabulary context: boost terms with aliases + pre-tokenized ids.

Behavioral parity: reference `CustomVocabulary/CustomVocabularyContext.swift:
3-100` + `ContextBiasingConstants`: JSON-configurable terms with aliases,
per-term minSimilarity, pre-tokenized TDT and CTC token ids, and size-aware
default thresholds (stricter when the vocabulary is large).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

from fluidaudio_tpu_torch.asr.custom_vocab.bktree import BKTree
from fluidaudio_tpu_torch.asr.tokenizer import Tokenizer

WILDCARD_TOKEN_ID = -2  # matches anything at zero cost (ContextBiasingConstants)


@dataclass
class VocabularyTerm:
    text: str
    aliases: list[str] = field(default_factory=list)
    min_similarity: float | None = None
    tdt_token_ids: list[int] | None = None
    ctc_token_ids: list[int] | None = None

    def __post_init__(self):
        # out-of-range thresholds clamp into [0, 1]
        # (CustomVocabularyTerm init, CustomVocabularyTests.swift:36-42)
        if self.min_similarity is not None:
            self.min_similarity = min(1.0, max(0.0, self.min_similarity))

    @property
    def text_lowercased(self) -> str:
        return self.text.lower()

    @property
    def all_forms(self) -> list[str]:
        return [self.text] + self.aliases


def _size_aware_min_similarity(n_terms: int) -> float:
    """Bigger vocabularies need stricter matching (ContextBiasingConstants)."""
    if n_terms <= 50:
        return 0.7
    if n_terms <= 200:
        return 0.78
    return 0.85


class CustomVocabularyContext:
    def __init__(self, terms: list[VocabularyTerm], tokenizer: Tokenizer | None = None,
                 *, min_term_length: int = 3):
        self.terms = terms
        # terms shorter than this never rescore (NeMo CTC-WS paper;
        # reference CustomVocabularyContext.minTermLength default 3)
        self.min_term_length = min_term_length
        self.default_min_similarity = _size_aware_min_similarity(len(terms))
        self.bktree = BKTree()
        self._by_form: dict[str, VocabularyTerm] = {}
        for term in terms:
            for form in term.all_forms:
                self.bktree.insert(form.lower(), term)
                self._by_form[form.lower()] = term
        if tokenizer is not None:
            self.pretokenize(tokenizer)

    @classmethod
    def from_json(cls, path: str | Path, tokenizer: Tokenizer | None = None
                  ) -> "CustomVocabularyContext":
        raw = json.loads(Path(path).read_text())
        terms = []
        for item in raw if isinstance(raw, list) else raw.get("terms", []):
            if isinstance(item, str):
                terms.append(VocabularyTerm(text=item))
            else:
                terms.append(
                    VocabularyTerm(
                        text=item["text"],
                        aliases=item.get("aliases", []),
                        min_similarity=item.get("minSimilarity"),
                    )
                )
        return cls(terms, tokenizer)

    @classmethod
    def from_file(cls, path: str | Path, tokenizer: Tokenizer | None = None
                  ) -> "CustomVocabularyContext":
        """Load a vocabulary file, sniffing the format
        (`CustomVocabulary.loadVocabularyFile`): a JSON array/object parses
        as `from_json`; anything else is a plain-text list, one term per
        line, `#` comments and blank lines skipped."""
        path = Path(path)
        content = path.read_text(encoding="utf-8")
        head = content.lstrip()[:1]
        if head in ("[", "{"):
            return cls.from_json(path, tokenizer)
        terms = [
            VocabularyTerm(text=line.strip())
            for line in content.splitlines()
            if line.strip() and not line.strip().startswith("#")
        ]
        return cls(terms, tokenizer)

    def pretokenize(self, tokenizer: Tokenizer) -> None:
        for term in self.terms:
            ids: list[int] = []
            ok = True
            for i, word in enumerate(term.text.split()):
                enc = tokenizer.encode_word(word, word_initial=True)
                if enc is None:
                    ok = False
                    break
                ids.extend(enc)
            if ok:
                term.tdt_token_ids = ids
                term.ctc_token_ids = ids

    def min_similarity(self, term: VocabularyTerm) -> float:
        return term.min_similarity if term.min_similarity is not None else self.default_min_similarity

    def lookup_exact(self, word: str) -> VocabularyTerm | None:
        return self._by_form.get(word.lower())

    def fuzzy_candidates(
        self, word: str, max_distance: int = 2
    ) -> list[tuple[VocabularyTerm, float]]:
        """Candidates with normalized similarity 1 - dist/maxlen, best first."""
        out = []
        seen: set[int] = set()
        for matched, dist, term in self.bktree.search(word, max_distance):
            if id(term) in seen:
                continue
            seen.add(id(term))
            sim = 1.0 - dist / max(len(word), len(matched), 1)
            out.append((term, sim))
        out.sort(key=lambda x: -x[1])
        return out
