"""Generic sequence overlap matching for chunk merge and streaming dedup.

Behavioral parity: reference `TokenDeduplication/SequenceMatcher.swift:3-40` —
suffix/prefix greedy match, bounded substring match, LCS backtrack, longest
contiguous run, and match consolidation. Pure host logic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence, TypeVar

T = TypeVar("T")
Matcher = Callable[[T, T], bool]


@dataclass(frozen=True)
class SequenceMatch:
    left_start: int
    right_start: int
    length: int


def find_suffix_prefix_match(
    previous: Sequence[T], current: Sequence[T], matcher: Matcher, max_overlap: int | None = None
) -> SequenceMatch | None:
    """Longest suffix of `previous` matching a prefix of `current` (len >= 2)."""
    limit = max_overlap if max_overlap is not None else max(len(previous), len(current))
    hi = min(limit, len(previous), len(current))
    for n in range(hi, 1, -1):
        if all(matcher(previous[len(previous) - n + i], current[i]) for i in range(n)):
            return SequenceMatch(len(previous) - n, 0, n)
    return None


def find_bounded_substring_match(
    previous: Sequence[T],
    current: Sequence[T],
    max_search_length: int,
    boundary_search: int,
    matcher: Matcher,
) -> SequenceMatch | None:
    if len(previous) < 2 or len(current) < 2:
        return None
    for n in range(min(max_search_length, len(current)), 1, -1):
        prev_start = max(0, len(previous) - max_search_length)
        for i in range(prev_start, len(previous) - n + 1):
            limit = min(boundary_search, max(0, len(current) - n + 1))
            for j in range(limit):
                if all(matcher(previous[i + k], current[j + k]) for k in range(n)):
                    return SequenceMatch(i, j, n)
    return None


def find_longest_common_subsequence(
    left: Sequence[T], right: Sequence[T], matcher: Matcher
) -> list[SequenceMatch]:
    """LCS via DP; returns single-element matches in order."""
    L, R = len(left), len(right)
    if L == 0 or R == 0:
        return []
    dp = [[0] * (R + 1) for _ in range(L + 1)]
    for i in range(1, L + 1):
        row, prev = dp[i], dp[i - 1]
        li = left[i - 1]
        for j in range(1, R + 1):
            if matcher(li, right[j - 1]):
                row[j] = prev[j - 1] + 1
            else:
                row[j] = prev[j] if prev[j] >= row[j - 1] else row[j - 1]
    matches: list[SequenceMatch] = []
    i, j = L, R
    while i > 0 and j > 0:
        if matcher(left[i - 1], right[j - 1]):
            matches.append(SequenceMatch(i - 1, j - 1, 1))
            i -= 1
            j -= 1
        elif dp[i - 1][j] > dp[i][j - 1]:
            i -= 1
        else:
            j -= 1
    return list(reversed(matches))


def find_contiguous_matches(
    left: Sequence[T], right: Sequence[T], matcher: Matcher
) -> list[SequenceMatch]:
    """Longest run of consecutive matches adjacent in both sequences."""
    best: list[SequenceMatch] = []
    for i in range(len(left)):
        for j in range(len(right)):
            if matcher(left[i], right[j]):
                current: list[SequenceMatch] = []
                k, l = i, j
                while k < len(left) and l < len(right) and matcher(left[k], right[l]):
                    current.append(SequenceMatch(k, l, 1))
                    k += 1
                    l += 1
                if len(current) > len(best):
                    best = current
    return best


def consolidate_matches(matches: list[SequenceMatch]) -> list[SequenceMatch]:
    if not matches:
        return []
    out: list[SequenceMatch] = []
    cur = matches[0]
    for nxt in matches[1:]:
        if (
            nxt.left_start == cur.left_start + cur.length
            and nxt.right_start == cur.right_start + cur.length
        ):
            cur = SequenceMatch(cur.left_start, cur.right_start, cur.length + nxt.length)
        else:
            out.append(cur)
            cur = nxt
    out.append(cur)
    return out


def remove_duplicate_token_sequence(
    previous: Sequence[int],
    current: Sequence[int],
    *,
    punctuation_tokens: frozenset[int] | set[int] = frozenset(),
    boundary_search_frames: int = 20,
    max_overlap: int = 12,
) -> tuple[list[int], int]:
    """Drop tokens at the head of `current` already emitted at the tail of
    `previous` (sequential-chunk boundary duplicates).

    Three stages, behavioral parity with reference
    `AsrManager+TokenProcessing.swift:110-165`:
    1. a single duplicated punctuation token (period/question/exclamation),
    2. exact suffix-prefix overlap up to `max_overlap` (min length 2),
    3. bounded substring search: the duplicate run may start up to
       `boundary_search_frames` tokens into `current`; everything up to and
       including the run is dropped.

    Returns (deduped current, removed leading count) so the caller can drop
    the same number of aligned timestamps/confidences.
    """
    working = list(current)
    removed = 0

    if previous and working and previous[-1] == working[0] and working[0] in punctuation_tokens:
        working = working[1:]
        removed += 1

    eq: Matcher = lambda a, b: a == b
    match = find_suffix_prefix_match(previous, working, eq, max_overlap)
    if match is not None:
        return working[match.length :], removed + match.length

    match = find_bounded_substring_match(
        previous, working, min(15, len(previous)), boundary_search_frames, eq
    )
    if match is not None:
        drop = match.right_start + match.length
        return working[drop:], removed + drop

    return working, removed
