"""Vocabulary rescoring: CTC-vs-CTC shallow fusion + token-splice fallback.

Behavioral parity: reference `CustomVocabulary/Rescorer/VocabularyRescorer*`
(~2k LoC across VocabularyRescorer.swift, +TokenRescoring (term-centric
algorithm, stopword sets), +TokenEvaluation (constrained-CTC match
evaluation, length-ratio/stopword rules), +Utilities (similarity,
normalization, capitalization), BKTree/+CandidateMatching) and
`ContextBiasingConstants.swift`.

Two entry points:

* `ctc_token_rescore(word_timings, log_probs, ...)` — the reference's
  primary path (`ctcTokenRescore`): for every vocabulary term, find
  similar TDT words/spans (multi-word aliases, 2-/3-word compound
  concatenations), score BOTH the term and the original phrase with a
  constrained CTC DP over the span's frame window (boundary and
  no-boundary tokenizations, best wins), add an adaptive context-biasing
  weight, and replace only when the boosted term score beats the
  original's acoustic evidence. Pending replacements are applied
  greedily after a quantized-similarity sort.

* `VocabularyRescorer.rescore(tokens, spots)` — token-splice variant for
  decode outputs without CTC log-probs: the same candidate matching
  (multi-word spans included) gated on string similarity, with a CTC
  keyword spot confirmation relaxing the gate; replacement splices the
  term's pre-tokenized TDT ids at word boundaries.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

import numpy as np

from fluidaudio_tpu_torch.asr.chunk import TokenWindow
from fluidaudio_tpu_torch.asr.constants import ASRConstants
from fluidaudio_tpu_torch.asr.custom_vocab.context import (
    WILDCARD_TOKEN_ID,
    CustomVocabularyContext,
    VocabularyTerm,
)
from fluidaudio_tpu_torch.asr.custom_vocab.ctc_spotter import (
    NEG_INF,
    KeywordSpot,
    ctc_keyword_dp,
    spot_keywords,
)
from fluidaudio_tpu_torch.asr.tokenizer import Tokenizer

_WB = ASRConstants.SENTENCEPIECE_WORD_BOUNDARY

# --------------------------------------------------------------------------
# ContextBiasingConstants parity
# --------------------------------------------------------------------------

MIN_SIMILARITY_FLOOR = 0.50
MULTI_WORD_MIN_SIMILARITY = 0.55  # requiredSimilarity for spans >= 2
LENGTH_RATIO_THRESHOLD = 0.75
SHORT_WORD_SIMILARITY = 0.80
SHORT_WORD_MAX_LENGTH = 4
STOPWORD_SPAN_SIMILARITY = 0.85
DEFAULT_CBW = 3.0
DEFAULT_MARGIN_SECONDS = 0.10
LARGE_VOCAB_THRESHOLD = 10
_MIN_LENGTH_FOR_2WORD = 4
_MIN_LENGTH_FOR_3WORD = 8
# confirmation from a CTC spot relaxes the similarity gate by this much
_SPOT_SIMILARITY_RELIEF = 0.1

# single-word rescue stopwords (prevents `just` -> `Wyost`); the wider set
STOPWORDS = frozenset(
    "a an the some any no every each all and or but so if then than as "
    "in on at to for of with by from up down out about into over after "
    "before between under is are was were be been being am have has had "
    "do does did will would can could go goes went come comes came get "
    "got take took make made say said see saw know knew think thought "
    "i you he she it we they me him her us them my your his its our "
    "their this that these those who what which where when how why "
    "just also only even still now here there very well back way own "
    "new old good great first last".split()
)

# multi-word span subset (function words only) so content-word spans like
# `new red` -> `Newrez` are not silently upgraded to the 0.85 threshold
MULTI_WORD_STOPWORDS = frozenset(
    "a an the some any no every each all and or but so if then than as "
    "in on at to for of with by from up down out about into over after "
    "before between under is are was were be been being am have has had "
    "do does did will would can could i you he she it we they me him "
    "her us them my your his its our their this that these those who "
    "what which where when how why".split()
)


@dataclass(frozen=True)
class RescorerConfig:
    """Rescoring behavior knobs (reference VocabularyRescorer.Config)."""

    use_adaptive_thresholds: bool = True
    reference_token_count: int = 3
    cbw: float = DEFAULT_CBW
    margin_seconds: float = DEFAULT_MARGIN_SECONDS
    # short-term cbw taper (#702, opt-in; pivot <= 1 disables)
    short_term_cbw_taper_pivot: int = 1
    short_term_cbw_taper_exponent: float = 2.0
    # spotter-anchored acoustic rescue (#724)
    spotter_rescue_enabled: bool = True
    spotter_rescue_min_similarity: float = 0.0

    def adaptive_cbw(self, base_cbw: float, token_count: int) -> float:
        """Longer keywords need more boost (accumulated scoring error);
        short ones taper so the flat boost cannot beat a correctly
        transcribed common word on its own."""
        if not self.use_adaptive_thresholds:
            return base_cbw
        pivot = self.short_term_cbw_taper_pivot
        if pivot > 1 and token_count < pivot:
            ratio = max(1, token_count) / pivot
            return base_cbw * ratio**self.short_term_cbw_taper_exponent
        ref = self.reference_token_count
        if token_count > ref:
            return base_cbw * (1.0 + math.log2(token_count / ref) * 0.3)
        return base_cbw


# --------------------------------------------------------------------------
# Utilities (reference VocabularyRescorer+Utilities.swift)
# --------------------------------------------------------------------------

_NORM_DROP = re.compile(r"[^0-9a-z'\-\s]+")


def normalize_for_similarity(text: str) -> str:
    """lowercase, strip punctuation (keep ' and -), collapse whitespace."""
    return " ".join(_NORM_DROP.sub("", text.lower()).split())


def is_word_boundary(token: str) -> bool:
    """True if the piece starts a new word: leading `▁` (SentencePiece) or
    space (reference `VocabularyRescorer+Utilities.swift:155-157`)."""
    return token.startswith(ASRConstants.SENTENCEPIECE_WORD_BOUNDARY) or token.startswith(" ")


def strip_word_boundary_prefix(token: str) -> str:
    """Drop ONE leading `▁`/space if present; internal markers stay
    (reference `VocabularyRescorer+Utilities.swift:165-170`)."""
    if is_word_boundary(token):
        return token[1:]
    return token


def string_similarity(a: str, b: str) -> float:
    from fluidaudio_tpu_torch.asr.custom_vocab.bktree import _edit_distance

    a, b = a.lower(), b.lower()
    max_len = max(len(a), len(b))
    if max_len == 0:
        return 1.0
    return 1.0 - _edit_distance(a, b) / max_len


def length_penalized_similarity(compound: str, vocab_term: str) -> float:
    base = string_similarity(compound, vocab_term)
    ratio = min(len(compound), len(vocab_term)) / max(
        len(compound), len(vocab_term), 1
    )
    return base * math.sqrt(ratio)


def preserve_capitalization(original: str, replacement: str) -> str:
    if original and original[0].isupper() and replacement and replacement[0].islower():
        return replacement[0].upper() + replacement[1:]
    return replacement


def required_similarity(min_similarity: float, span_length: int) -> float:
    if span_length >= 2:
        return max(min_similarity, MULTI_WORD_MIN_SIMILARITY)
    return min_similarity


def encode_variants(tokenizer: Tokenizer, phrase: str) -> list[list[int]]:
    """Standard (leading `▁`) and mid-utterance (no leading boundary)
    tokenizations; compound matches like `Liv`+`marli` -> `Livmarli` do not
    begin at a word boundary, so the `▁` token has no acoustic counterpart
    (reference CtcTokenizer.encodeVariants)."""
    words = phrase.split()
    if not words:
        return []
    out: list[list[int]] = []
    for first_initial in (True, False):
        ids: list[int] = []
        ok = True
        for i, w in enumerate(words):
            initial = first_initial or i > 0
            # sentence-case hypothesis words often miss the piece vocab;
            # fall back to the lower-cased form
            enc = tokenizer.encode_word(w, word_initial=initial)
            if enc is None:
                enc = tokenizer.encode_word(w.lower(), word_initial=initial)
            if enc is None:
                ok = False
                break
            ids.extend(enc)
        if ok and ids and ids not in out:
            out.append(ids)
    return out


def ctc_word_spot_constrained(
    log_probs: np.ndarray,
    keyword_tokens: list[int],
    search_start_frame: int,
    search_end_frame: int,
    blank_id: int,
) -> tuple[float, int, int]:
    """Best constrained CTC alignment of the keyword inside the frame
    window; score normalized by non-wildcard token count (reference
    CtcDPAlgorithm.ctcWordSpotConstrained)."""
    T = log_probs.shape[0]
    start = max(0, search_start_frame)
    end = min(T, search_end_frame)
    n = len(keyword_tokens)
    if n == 0 or end <= start or end - start < n:
        return -float("inf"), start, start
    window = log_probs[start:end]
    dp, bt = ctc_keyword_dp(window, keyword_tokens, blank_id)
    scores = dp[:, n]
    best_t = int(np.argmax(scores))
    raw = float(scores[best_t])
    if raw <= NEG_INF / 2:
        return -float("inf"), start, start
    norm = sum(1 for t in keyword_tokens if t != WILDCARD_TOKEN_ID) or 1
    return raw / norm, start + int(bt[best_t, n]), start + best_t


# --------------------------------------------------------------------------
# Candidate matching (shared between the CTC and token-splice paths)
# --------------------------------------------------------------------------


@dataclass
class MatchCandidate:
    term: VocabularyTerm
    span_start: int  # first word index
    span_length: int
    similarity: float
    original_phrase: str  # raw words joined by space


def _normalized_forms(term: VocabularyTerm) -> list[tuple[str, int]]:
    seen: set[str] = set()
    forms: list[tuple[str, int]] = []
    for raw in term.all_forms:
        norm = normalize_for_similarity(raw)
        if norm and norm not in seen:
            seen.add(norm)
            forms.append((norm, len(norm.split())))
    return forms


def find_candidates(
    context: CustomVocabularyContext,
    raw_words: list[str],
    *,
    replaced: set[int] | None = None,
    gate_relief: dict[int, float] | None = None,
    relief_terms: set[str] | None = None,
) -> list[MatchCandidate]:
    """Term-centric matching over the hypothesis words (reference
    rescoreWithConstrainedCTCTermCentric steps 1-2): multi-word alias
    spans, single words, and 2-/3-word compound concatenations, with
    exact-match/other-term guards, length-ratio and stopword rules.
    `gate_relief[word_idx]` lowers the similarity gate for spans starting
    there (CTC spot confirmation); when `relief_terms` is given, relief
    applies only to those (lower-cased) term texts."""
    replaced = replaced or set()
    base_relief = gate_relief or {}
    norm_words = [normalize_for_similarity(w) for w in raw_words]
    vocab_norm_set = {
        normalize_for_similarity(f)
        for t in context.terms
        for f in t.all_forms
    }
    min_term_length = getattr(context, "min_term_length", 3)
    out: list[MatchCandidate] = []

    for term in context.terms:
        if len(term.text) < min_term_length:
            continue
        relief = (
            base_relief
            if relief_terms is None or term.text.lower() in relief_terms
            else {}
        )
        term_min_sim = context.min_similarity(term)
        forms = _normalized_forms(term)
        if not forms:
            continue
        norm_canonical = normalize_for_similarity(term.text)
        own_norms = {f for f, _ in forms}
        multi = [(f, wc) for f, wc in forms if wc > 1]
        single = [(f, wc) for f, wc in forms if wc == 1]

        if multi:
            max_wc = max(wc for _, wc in multi)
            min_wc = min(wc for _, wc in multi)
            max_span = min(4, max_wc + 1)
            min_span = max(2, min_wc)
            for span_len in range(min_span, max_span + 1):
                if span_len > len(raw_words):
                    break
                for start in range(len(raw_words) - span_len + 1):
                    idxs = range(start, start + span_len)
                    if any(i in replaced for i in idxs):
                        continue
                    phrase_norm = " ".join(
                        norm_words[i] for i in idxs if norm_words[i]
                    )
                    if not phrase_norm or phrase_norm == norm_canonical:
                        continue
                    if phrase_norm in vocab_norm_set and phrase_norm not in own_norms:
                        continue  # matches a DIFFERENT vocabulary term
                    best = max(string_similarity(phrase_norm, f) for f, _ in multi)
                    # NB: no stopword-span raise here — multi-word FORMS
                    # legitimately contain function words ("weights and
                    # biases"); the raise applies only to compound spans
                    # in the single-word path (reference TokenRescoring
                    # checkStopwordRules call sites)
                    gate = required_similarity(term_min_sim, span_len)
                    gate -= relief.get(start, 0.0)
                    if best >= gate:
                        out.append(
                            MatchCandidate(
                                term=term,
                                span_start=start,
                                span_length=span_len,
                                similarity=best,
                                original_phrase=" ".join(
                                    raw_words[i] for i in idxs
                                ),
                            )
                        )

        if single:
            for wi, norm_word in enumerate(norm_words):
                if wi in replaced or not norm_word:
                    continue
                if norm_word == norm_canonical:
                    continue
                if norm_word in vocab_norm_set and norm_word not in own_norms:
                    continue
                best = max(string_similarity(norm_word, f) for f, _ in single)
                span_len = 1

                # compound matching: `Liv Mali` -> `Livmarli` (2-word needs
                # vocab len >= 4, 3-word >= 8; skip when a later word in
                # the compound already matches the term well on its own)
                norm2 = (
                    norm_words[wi + 1]
                    if wi + 1 < len(norm_words) and (wi + 1) not in replaced
                    else None
                )
                norm3 = (
                    norm_words[wi + 2]
                    if wi + 2 < len(norm_words) and (wi + 2) not in replaced
                    else None
                )
                if norm2 and len(term.text) >= _MIN_LENGTH_FOR_2WORD:
                    if not any(string_similarity(norm2, f) >= 0.9 for f, _ in single):
                        concat = norm_word + norm2
                        s2 = max(string_similarity(concat, f) for f, _ in single)
                        if s2 > best:
                            best, span_len = s2, 2
                if norm2 and norm3 and len(term.text) >= _MIN_LENGTH_FOR_3WORD:
                    later_matches = any(
                        string_similarity(w, f) >= 0.9
                        for w in (norm2, norm3)
                        for f, _ in single
                    )
                    if not later_matches:
                        concat = norm_word + norm2 + norm3
                        s3 = max(string_similarity(concat, f) for f, _ in single)
                        if s3 > best:
                            best, span_len = s3, 3

                gate = required_similarity(term_min_sim, span_len)
                if span_len == 1:
                    # length-ratio rule: very short hypothesis words need
                    # much higher similarity to replace
                    ratio = len(norm_word) / max(len(term.text), 1)
                    if (
                        ratio < LENGTH_RATIO_THRESHOLD
                        and len(norm_word) <= SHORT_WORD_MAX_LENGTH
                    ):
                        gate = max(gate, SHORT_WORD_SIMILARITY)
                    if norm_word in STOPWORDS:
                        continue  # lone stopwords never replaced
                else:
                    span_norms = norm_words[wi : wi + span_len]
                    if any(w in MULTI_WORD_STOPWORDS for w in span_norms):
                        gate = max(gate, STOPWORD_SPAN_SIMILARITY)
                gate -= relief.get(wi, 0.0)
                if best >= gate:
                    out.append(
                        MatchCandidate(
                            term=term,
                            span_start=wi,
                            span_length=span_len,
                            similarity=best,
                            original_phrase=" ".join(
                                raw_words[wi : wi + span_len]
                            ),
                        )
                    )
    return out


def select_candidates(candidates: list[MatchCandidate]) -> list[MatchCandidate]:
    """Greedy non-overlapping selection after quantized-similarity sort:
    0.05-wide buckets (strict weak ordering — raw-diff comparison is
    non-transitive), shorter spans tiebreak within a bucket (reference
    finalizeReplacements)."""
    ordered = sorted(
        candidates,
        key=lambda c: (-round(c.similarity / 0.05), c.span_length, -c.similarity),
    )
    taken: set[int] = set()
    out: list[MatchCandidate] = []
    for c in ordered:
        span = range(c.span_start, c.span_start + c.span_length)
        if any(i in taken for i in span):
            continue
        taken.update(span)
        out.append(c)
    return out


# --------------------------------------------------------------------------
# CTC-vs-CTC rescoring (the reference's primary path)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class WordTiming:
    word: str
    start_time: float
    end_time: float


@dataclass
class RescoringResult:
    original: str
    replacement: str
    original_score: float
    boosted_vocab_score: float
    reason: str


@dataclass
class RescoreOutput:
    text: str
    replacements: list[RescoringResult] = field(default_factory=list)

    @property
    def was_modified(self) -> bool:
        return bool(self.replacements)


def ctc_token_rescore(
    word_timings: list[WordTiming],
    log_probs: np.ndarray,  # [T, V] CTC log-probs
    frame_duration: float,
    context: CustomVocabularyContext,
    tokenizer: Tokenizer,
    *,
    blank_id: int,
    config: RescorerConfig | None = None,
) -> RescoreOutput:
    """Constrained-CTC term-centric rescoring (reference ctcTokenRescore /
    rescoreWithConstrainedCTCTermCentric): replace a hypothesis span with
    a vocabulary term only when the term's constrained CTC score (best of
    boundary/no-boundary tokenizations) plus the adaptive context-biasing
    weight beats the original phrase's own CTC score over the same frame
    window (± margin)."""
    cfg = config or RescorerConfig()
    if not word_timings or log_probs.size == 0:
        return RescoreOutput(text=" ".join(w.word for w in word_timings))
    lp = np.asarray(log_probs, np.float64)
    raw_words = [w.word for w in word_timings]

    # spotter-anchored rescue gate relief: small vocabularies only — on
    # large ones keyword-vs-keyword competition over-fires (`and` ->
    # `Evenity`); the similarity path already covers those.
    relief: dict[int, float] = {}
    spot_results: list[KeywordSpot] = []
    if cfg.spotter_rescue_enabled and len(context.terms) <= LARGE_VOCAB_THRESHOLD:
        keywords = {
            t.text: (t.ctc_token_ids or t.tdt_token_ids or [])
            for t in context.terms
        }
        keywords = {k: v for k, v in keywords.items() if v}
        if keywords:
            spot_results = spot_keywords(lp, keywords, blank_id)
            for spot in spot_results:
                t0 = spot.start_frame * frame_duration
                t1 = spot.end_frame * frame_duration
                for wi, wt in enumerate(word_timings):
                    if wt.end_time >= t0 and wt.start_time <= t1:
                        relief[wi] = max(
                            relief.get(wi, 0.0), _SPOT_SIMILARITY_RELIEF
                        )

    candidates = find_candidates(context, raw_words, gate_relief=relief)

    # evaluate every candidate acoustically
    pending: list[tuple[MatchCandidate, RescoringResult]] = []
    margin_frames = int(cfg.margin_seconds / frame_duration)
    for cand in candidates:
        first = word_timings[cand.span_start]
        last = word_timings[cand.span_start + cand.span_length - 1]
        start_f = int(first.start_time / frame_duration) - margin_frames
        end_f = int(last.end_time / frame_duration) + margin_frames

        vocab_score = -float("inf")
        tokens_used: list[int] = []
        for variant in encode_variants(tokenizer, cand.term.text):
            s, _, _ = ctc_word_spot_constrained(lp, variant, start_f, end_f, blank_id)
            if s > vocab_score:
                vocab_score, tokens_used = s, variant
        if not tokens_used:
            continue

        orig_variants = encode_variants(tokenizer, cand.original_phrase)
        if not orig_variants:
            continue
        orig_score = max(
            ctc_word_spot_constrained(lp, v, start_f, end_f, blank_id)[0]
            for v in orig_variants
        )

        boosted = vocab_score + cfg.adaptive_cbw(cfg.cbw, len(tokens_used))
        if boosted > orig_score:
            first_word = cand.original_phrase.split()[0]
            replacement = preserve_capitalization(first_word, cand.term.text)
            pending.append(
                (
                    cand,
                    RescoringResult(
                        original=cand.original_phrase,
                        replacement=replacement,
                        original_score=orig_score,
                        boosted_vocab_score=boosted,
                        reason=(
                            f"CTC-vs-CTC: '{cand.term.text}'={boosted:.2f} > "
                            f"'{cand.original_phrase}'={orig_score:.2f}"
                        ),
                    ),
                )
            )

    chosen = select_candidates([c for c, _ in pending])
    by_id = {id(c): r for c, r in pending}
    modified = list(raw_words)
    replacements: list[RescoringResult] = []
    for cand in chosen:
        res = by_id[id(cand)]
        modified[cand.span_start] = res.replacement
        for i in range(cand.span_start + 1, cand.span_start + cand.span_length):
            modified[i] = ""
        replacements.append(res)
    text = " ".join(w for w in modified if w)
    return RescoreOutput(text=text, replacements=replacements)


# --------------------------------------------------------------------------
# Token-splice rescorer (decode outputs without CTC log-probs)
# --------------------------------------------------------------------------


@dataclass
class RescoreResult:
    tokens: list[TokenWindow]
    replacements: list[tuple[str, str]]  # (original phrase, term text)


class VocabularyRescorer:
    def __init__(
        self,
        context: CustomVocabularyContext,
        tokenizer: Tokenizer,
        config: RescorerConfig | None = None,
    ):
        self.context = context
        self.tokenizer = tokenizer
        self.config = config or RescorerConfig()
        if any(t.tdt_token_ids is None for t in context.terms):
            context.pretokenize(tokenizer)

    def rescore(
        self,
        tokens: list[TokenWindow],
        spots: list[KeywordSpot] | None = None,
    ) -> RescoreResult:
        """Splice boosted terms into the TDT token stream. Candidate
        matching is shared with the CTC path (multi-word aliases and
        compound spans included); without log-probs the gate is string
        similarity, relaxed by a CTC spot confirmation of the term."""
        words = self._group_words(tokens)
        raw_words = [self._word_text(w) for w in words]

        spotted = {s.keyword.lower() for s in (spots or [])}
        if spotted:
            # a spot whose term ALREADY appears verbatim in the hypothesis
            # is explained by that occurrence — relaxing the gate for it
            # would let fuzzy NEIGHBOR spans (sharing a word with the exact
            # occurrence) steal a replacement and duplicate the term
            norm_words = [normalize_for_similarity(w) for w in raw_words]
            for term in self.context.terms:
                if term.text.lower() not in spotted:
                    continue
                t_norm = normalize_for_similarity(term.text).split()
                n = len(t_norm)
                if n and any(
                    norm_words[i : i + n] == t_norm
                    for i in range(len(norm_words) - n + 1)
                ):
                    spotted.discard(term.text.lower())
        relief: dict[int, float] = {}
        if spotted:
            # a spot confirms the TERM acoustically; relax the gate at
            # every position (span alignment is unknown without timings),
            # but only for the terms actually spotted
            relief = {i: _SPOT_SIMILARITY_RELIEF for i in range(len(words))}

        candidates = find_candidates(
            self.context, raw_words, gate_relief=relief, relief_terms=spotted
        )
        chosen = select_candidates(
            [c for c in candidates if c.term.tdt_token_ids]
        )

        by_start = {c.span_start: c for c in chosen}
        covered: set[int] = set()
        out: list[TokenWindow] = []
        replacements: list[tuple[str, str]] = []
        for wi, word_tokens in enumerate(words):
            if wi in covered:
                continue
            cand = by_start.get(wi)
            if cand is None:
                out.extend(word_tokens)
                continue
            span = range(wi, wi + cand.span_length)
            covered.update(span)
            # all spliced tokens share the first word's timestamp:
            # base_ts + i could overrun the NEXT word's frames and break
            # timestamp monotonicity for consumers
            base_ts = word_tokens[0].timestamp
            out.extend(
                TokenWindow(tid, base_ts, word_tokens[0].confidence)
                for tid in cand.term.tdt_token_ids
            )
            # keep punctuation attached to the original span ('acme,' ->
            # 'ACME,'): trailing non-word pieces from the LAST span word
            last_word = words[wi + cand.span_length - 1]
            for tok in last_word:
                piece = (self.tokenizer.piece(tok.token) or "").strip(_WB + " ")
                if piece and all(not c.isalnum() for c in piece):
                    out.append(tok)
            replacements.append(
                (normalize_for_similarity(cand.original_phrase), cand.term.text)
            )
        return RescoreResult(tokens=out, replacements=replacements)

    def _group_words(self, tokens: list[TokenWindow]) -> list[list[TokenWindow]]:
        words: list[list[TokenWindow]] = []
        for tok in tokens:
            piece = self.tokenizer.piece(tok.token)
            if not words or piece.startswith(_WB) or piece.startswith(" "):
                words.append([tok])
            else:
                words[-1].append(tok)
        return words

    def _word_text(self, word_tokens: list[TokenWindow]) -> str:
        text = "".join(self.tokenizer.piece(t.token) for t in word_tokens)
        return text.replace(_WB, "").strip()
