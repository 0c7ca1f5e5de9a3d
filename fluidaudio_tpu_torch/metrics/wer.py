"""WER/CER with alignment breakdown.

Behavioral parity: reference CLI `WERCalculator` (240 LoC) +
`LevenshteinDistance` (34 LoC): token-level edit distance with
substitution/insertion/deletion counts.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class WerBreakdown:
    errors: int
    substitutions: int
    insertions: int
    deletions: int
    reference_length: int

    @property
    def rate(self) -> float:
        return self.errors / self.reference_length if self.reference_length else 0.0


def levenshtein(a: list[str], b: list[str]) -> WerBreakdown:
    """Edit distance from reference `a` to hypothesis `b` with op counts."""
    n, m = len(a), len(b)
    # dp[i][j] = (cost, subs, ins, dels)
    prev = [(j, 0, j, 0) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, 0, i)]
        for j in range(1, m + 1):
            if a[i - 1] == b[j - 1]:
                cur.append(prev[j - 1])
                continue
            sub = prev[j - 1]
            ins = cur[j - 1]
            dele = prev[j]
            best = min(sub[0], ins[0], dele[0])
            if best == sub[0]:
                cur.append((sub[0] + 1, sub[1] + 1, sub[2], sub[3]))
            elif best == dele[0]:
                cur.append((dele[0] + 1, dele[1], dele[2], dele[3] + 1))
            else:
                cur.append((ins[0] + 1, ins[1], ins[2] + 1, ins[3]))
        prev = cur
    cost, subs, ins, dels = prev[m]
    return WerBreakdown(cost, subs, ins, dels, n)


def wer(reference: str, hypothesis: str) -> WerBreakdown:
    return levenshtein(reference.split(), hypothesis.split())


def cer(reference: str, hypothesis: str) -> WerBreakdown:
    return levenshtein(list(reference.replace(" ", "")), list(hypothesis.replace(" ", "")))
