"""CTC decoding: batched greedy on the device + prefix beam search with
optional ARPA n-gram rescoring (host), in PyTorch.

Port of `fluidaudio_tpu/ops/ctc_decode.py` (reference
`SlidingWindow/CTC/CtcDecoder.swift` greedy/beam +
`CTC/ARPALanguageModel.swift`). The greedy collapse is a vectorised device
op with no host round trip; beam search and the ARPA reader are host logic
over log-probs, copied unchanged.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch


def ctc_greedy_decode(
    log_probs: torch.Tensor, lengths: torch.Tensor, blank_id: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, T, V] log-probs -> (tokens [B, T], frames [B, T], counts [B]), int32,
    on the log-probs' device.

    Collapses repeats then removes blanks, fully vectorised (no host loop).
    Output rows are left-packed by a stable sort of the dropped-frame flag
    (an int32 key), so kept frames keep their order; positions >= counts are
    blank_id.
    """
    B, T, _ = log_probs.shape
    dev = log_probs.device
    lengths = torch.as_tensor(lengths, device=dev)
    best = torch.argmax(log_probs, dim=-1).to(torch.int32)  # first max, as jnp.argmax
    steps = torch.arange(T, dtype=torch.int32, device=dev)
    valid = steps[None, :] < lengths[:, None]
    prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32, device=dev), best[:, :-1]], dim=1)
    keep = (best != blank_id) & (best != prev) & valid  # new non-blank emissions

    order = torch.sort((~keep).to(torch.int32), dim=1, stable=True).indices
    packed_tokens = torch.gather(best, 1, order)
    packed_frames = order.to(torch.int32)
    counts = keep.sum(dim=1, dtype=torch.int32)
    packed_tokens = torch.where(steps[None, :] < counts[:, None], packed_tokens,
                                torch.full_like(packed_tokens, blank_id))
    return packed_tokens, packed_frames, counts


class ARPALanguageModel:
    """Minimal ARPA n-gram reader (log10 probs + backoff) for beam rescoring."""

    def __init__(self, ngrams: dict[tuple[str, ...], tuple[float, float]], order: int):
        self.ngrams = ngrams
        self.order = order

    @classmethod
    def load(cls, path: str | Path) -> "ARPALanguageModel":
        ngrams: dict[tuple[str, ...], tuple[float, float]] = {}
        order = 1
        current = 0
        for line in Path(path).read_text().splitlines():
            line = line.strip()
            if line.startswith("\\") and "-grams:" in line:
                current = int(line[1 : line.index("-")])
                order = max(order, current)
                continue
            if not line or line.startswith("\\") or "=" in line:
                continue
            parts = line.split("\t")
            if len(parts) < 2 or current == 0:
                continue
            logp = float(parts[0])
            words = tuple(parts[1].split())
            backoff = float(parts[2]) if len(parts) > 2 else 0.0
            ngrams[words] = (logp, backoff)
        return cls(ngrams, order)

    def score(self, context: tuple[str, ...], word: str) -> float:
        """log10 P(word | context) with backoff."""
        for n in range(min(len(context), self.order - 1), -1, -1):
            key = context[len(context) - n :] + (word,)
            if key in self.ngrams:
                logp = self.ngrams[key][0]
                # accumulate backoff weights of skipped contexts
                for k in range(n + 1, min(len(context), self.order - 1) + 1):
                    ctx = context[len(context) - k :]
                    if ctx in self.ngrams:
                        logp += self.ngrams[ctx][1]
                return logp
        return -99.0



def ctc_beam_search(
    log_probs: np.ndarray,
    blank_id: int,
    beam_width: int = 8,
    vocabulary: dict[int, str] | None = None,
    lm: ARPALanguageModel | None = None,
    lm_weight: float = 0.5,
) -> list[int]:
    """Prefix beam search over [T, V] log-probs (single utterance, host)."""

    def logsumexp2(a: float, b: float) -> float:
        if a == -math.inf:
            return b
        if b == -math.inf:
            return a
        m = max(a, b)
        return m + math.log(math.exp(a - m) + math.exp(b - m))

    T, V = log_probs.shape
    # prefix -> (p_blank, p_non_blank)
    beams: dict[tuple[int, ...], tuple[float, float]] = {(): (0.0, -math.inf)}
    topk = min(V, max(beam_width * 4, 16))

    for t in range(T):
        frame = log_probs[t]
        cand_ids = np.argpartition(-frame, topk - 1)[:topk]
        next_beams: dict[tuple[int, ...], tuple[float, float]] = {}

        def add(prefix, pb, pnb):
            opb, opnb = next_beams.get(prefix, (-math.inf, -math.inf))
            next_beams[prefix] = (logsumexp2(opb, pb), logsumexp2(opnb, pnb))

        for prefix, (pb, pnb) in beams.items():
            total = logsumexp2(pb, pnb)
            # blank extends both
            add(prefix, total + frame[blank_id], -math.inf)
            last = prefix[-1] if prefix else None
            for c in cand_ids:
                c = int(c)
                if c == blank_id:
                    continue
                p = float(frame[c])
                if c == last:
                    # repeated token: extend non-blank stays same prefix
                    add(prefix, -math.inf, pnb + p)
                    # new emission only after a blank
                    add(prefix + (c,), -math.inf, pb + p)
                else:
                    lm_bonus = 0.0
                    if lm is not None and vocabulary is not None:
                        piece = vocabulary.get(c, "")
                        if piece.startswith("▁") and prefix:
                            words = _prefix_words(prefix, vocabulary)
                            if words:
                                lm_bonus = lm_weight * lm.score(
                                    tuple(words[:-1][-3:]), words[-1]
                                ) * math.log(10)
                    add(prefix + (c,), -math.inf, total + p + lm_bonus)

        scored = sorted(
            next_beams.items(), key=lambda kv: -logsumexp2(kv[1][0], kv[1][1])
        )
        beams = dict(scored[:beam_width])

    def final_score(prefix: tuple[int, ...], probs: tuple[float, float]) -> float:
        """Total + LM score of the trailing (not-yet-boundary-closed) word
        (ref `CtcDecoder.swift:230-238` finalize pass)."""
        total = logsumexp2(*probs)
        if lm is not None and vocabulary is not None and prefix:
            words = _prefix_words(prefix, vocabulary)
            if words:
                total += (
                    lm_weight
                    * lm.score(tuple(words[:-1][-3:]), words[-1])
                    * math.log(10)
                )
        return total

    best = max(beams.items(), key=lambda kv: final_score(kv[0], kv[1]))
    return list(best[0])


def _prefix_words(prefix: tuple[int, ...], vocabulary: dict[int, str]) -> list[str]:
    text = "".join(vocabulary.get(t, "") for t in prefix)
    return text.replace("▁", " ").split()
