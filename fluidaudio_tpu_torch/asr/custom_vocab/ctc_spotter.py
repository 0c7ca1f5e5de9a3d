"""CTC keyword spotting DP (NeMo CTC-WS, arXiv:2406.07096).

Behavioral parity: reference `WordSpotting/CtcDPAlgorithm.swift` (393 LoC):
DP over the blank-expanded symbol sequence [B, t1, B, ..., tN, B] with
stay/advance/skip-blank transitions (repeated tokens must pass through the
intervening blank); wildcard tokens match free; free start at every frame;
per-frame score normalization. `spot_keywords` applies temperature + blank
bias preprocessing (reference CtcKeywordSpotter defaults).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fluidaudio_tpu_torch.asr.custom_vocab.context import WILDCARD_TOKEN_ID

NEG_INF = -1e30


@dataclass(frozen=True)
class KeywordSpot:
    keyword: str
    start_frame: int
    end_frame: int
    score: float  # per-frame normalized log-prob
    raw_score: float


def ctc_keyword_dp(
    log_probs: np.ndarray, keyword_tokens: list[int], blank_id: int
) -> tuple[np.ndarray, np.ndarray]:
    """DP over [T, V] log-probs; returns (dp [T+1, N+1], backtrack [T+1, N+1]).

    dp[t][n] = best raw score consuming the first n tokens by frame t
    (including blank emissions); backtrack = inferred start frame. Free start:
    dp[t][0] = 0 for all t.
    """
    T, V = log_probs.shape
    N = len(keyword_tokens)
    # expanded sequence: index 2i = blank before token i; 2i+1 = token i; 2N = final blank
    L = 2 * N + 1

    def emission(sym_idx: int, t: int) -> float:
        if sym_idx % 2 == 0:  # blank
            return float(log_probs[t, blank_id]) if 0 <= blank_id < V else 0.0
        tok = keyword_tokens[sym_idx // 2]
        if tok == WILDCARD_TOKEN_ID:
            return 0.0
        return float(log_probs[t, tok]) if 0 <= tok < V else NEG_INF

    def can_skip(sym_idx: int) -> bool:
        if sym_idx < 2 or sym_idx % 2 == 0:
            return False
        cur = keyword_tokens[sym_idx // 2]
        prev = keyword_tokens[(sym_idx - 2) // 2]
        if cur == WILDCARD_TOKEN_ID and prev == WILDCARD_TOKEN_ID:
            return False
        return cur != prev or cur == WILDCARD_TOKEN_ID

    dpi = np.full((T + 1, L), NEG_INF)
    bti = np.zeros((T + 1, L), np.int64)
    for t in range(T):
        # free start: enter state 0 (leading blank) or state 1 (first token) at t
        row_prev = dpi[t]
        row = dpi[t + 1]
        bt_prev = bti[t]
        bt = bti[t + 1]
        for s in range(L):
            e = emission(s, t)
            # stay
            best = row_prev[s]
            best_bt = bt_prev[s]
            # advance from s-1
            if s >= 1 and row_prev[s - 1] > best:
                best = row_prev[s - 1]
                best_bt = bt_prev[s - 1]
            # skip blank from s-2
            if can_skip(s) and row_prev[s - 2] > best:
                best = row_prev[s - 2]
                best_bt = bt_prev[s - 2]
            # free start into the first two states
            if s <= 1 and 0.0 > best:
                best = 0.0
                best_bt = t
            row[s] = best + e if best > NEG_INF / 2 else NEG_INF
            bt[s] = best_bt

    dp = np.full((T + 1, N + 1), NEG_INF)
    backtrack = np.zeros((T + 1, N + 1), np.int64)
    dp[:, 0] = 0.0
    for t in range(T + 1):
        backtrack[t, 0] = t
        for n in range(1, N + 1):
            a = dpi[t, 2 * n - 1]
            b = dpi[t, 2 * n]
            if a >= b:
                dp[t, n] = a
                backtrack[t, n] = bti[t, 2 * n - 1]
            else:
                dp[t, n] = b
                backtrack[t, n] = bti[t, 2 * n]
    return dp, backtrack


def spot_keywords(
    log_probs: np.ndarray,
    keywords: dict[str, list[int]],
    blank_id: int,
    *,
    min_score: float = -2.5,  # per-frame normalized
    temperature: float = 1.0,
    blank_bias: float = 0.0,
) -> list[KeywordSpot]:
    """Find best non-overlapping occurrence windows per keyword."""
    lp = np.asarray(log_probs, np.float64)
    if temperature != 1.0:
        lp = lp / temperature
        lp -= np.log(np.exp(lp).sum(axis=1, keepdims=True))
    if blank_bias:
        lp = lp.copy()
        lp[:, blank_id] += blank_bias

    T = lp.shape[0]
    spots: list[KeywordSpot] = []
    for word, tokens in keywords.items():
        if not tokens:
            continue
        dp, bt = ctc_keyword_dp(lp, tokens, blank_id)
        n = len(tokens)
        best_t = int(np.argmax(dp[:, n]))
        raw = float(dp[best_t, n])
        if raw <= NEG_INF / 2:
            continue
        start = int(bt[best_t, n])
        span = max(1, best_t - start)
        score = raw / span
        if score >= min_score:
            spots.append(
                KeywordSpot(
                    keyword=word, start_frame=start, end_frame=best_t,
                    score=score, raw_score=raw,
                )
            )
    spots.sort(key=lambda s: s.start_frame)
    return spots
