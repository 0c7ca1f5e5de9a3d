"""Punctuation-aware committed/ghost text splitter for streaming UX.

Behavioral parity: reference `ASR/Shared/PunctuationCommitLayer.swift`:
partial text accumulates as "ghost" until punctuation (., !, ?) commits it
(`:160-231`); a debounce timeout (default 3 s) commits mid-sentence pauses
— the timer is armed only by a no-punctuation partial and cancelled by any
commit/reset (`:341-376`); EOU and manual commits promote the ghost with a
separator space only when the committed text doesn't already end in
whitespace and never append a trailing space (`:236-308`); reset clears
state and still notifies the callback (`:311-327`). Python version is
synchronous: the caller supplies a monotonic clock and polls
`check_debounce()` instead of the reference's actor + timer task.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

PUNCTUATION_MARKS = {".", "!", "?"}


@dataclass(frozen=True)
class CommitLayerUpdate:
    committed_text: str
    ghost_text: str
    total_text: str
    last_commit_reason: str | None  # "punctuation:<c>" | "debounce" | "manual" | "eou"
    timestamp: float


class PunctuationCommitLayer:
    def __init__(
        self,
        debounce_timeout: float = 3.0,
        commit_on_timeout: bool = True,
        punctuation_marks: set[str] | None = None,
        clock: Callable[[], float] = time.monotonic,
        on_update: Callable[[CommitLayerUpdate], None] | None = None,
    ):
        self.debounce_timeout = debounce_timeout
        self.commit_on_timeout = commit_on_timeout
        self.punctuation_marks = punctuation_marks or set(PUNCTUATION_MARKS)
        self._clock = clock
        self.on_update = on_update
        self._committed = ""
        self._ghost = ""
        self._last_update = clock()
        self._debounce_armed = False

    # ------------------------------------------------------------------ core

    def _update(self, reason: str | None) -> CommitLayerUpdate:
        total = (
            self._committed + self._ghost
            if self._committed and self._ghost
            else self._committed or self._ghost
        )
        update = CommitLayerUpdate(
            committed_text=self._committed,
            ghost_text=self._ghost,
            total_text=total,
            last_commit_reason=reason,
            timestamp=self._clock(),
        )
        if self.on_update:
            self.on_update(update)
        return update

    def _commit_ghost(self, reason: str) -> CommitLayerUpdate:
        """Promote ghost to committed (ref `commitGhostText` :379-400):
        separator space only when needed, no trailing space."""
        self._debounce_armed = False
        self._last_update = self._clock()
        if not self._ghost:
            return self._update(reason)
        if self._committed and not self._committed[-1].isspace():
            self._committed += " "
        self._committed += self._ghost
        self._ghost = ""
        return self._update(reason)

    def process_partial_text(self, text: str) -> CommitLayerUpdate:
        self._last_update = self._clock()
        last_punc = max(
            (i for i, c in enumerate(text) if c in self.punctuation_marks), default=-1
        )
        if last_punc >= 0:
            self._debounce_armed = False
            commit_end = last_punc + 1
            ghost_start = commit_end
            while ghost_start < len(text) and text[ghost_start].isspace():
                ghost_start += 1
            whitespace = text[commit_end:ghost_start] or " "
            self._committed += text[:commit_end] + whitespace
            self._ghost = text[ghost_start:]
            return self._update(f"punctuation:{text[last_punc]}")
        self._ghost = text
        self._debounce_armed = True
        return self._update(None)

    def check_debounce(self) -> CommitLayerUpdate | None:
        """Commit the ghost when the debounce window expired (poll-based
        stand-in for the reference's timer task)."""
        if not self._debounce_armed or not self.commit_on_timeout:
            return None
        if not self._ghost or self._clock() - self._last_update < self.debounce_timeout:
            return None
        return self._commit_ghost("debounce")

    def process_eou(self) -> CommitLayerUpdate:
        return self._commit_ghost("eou")

    def manual_commit(self) -> CommitLayerUpdate:
        return self._commit_ghost("manual")

    def reset(self) -> CommitLayerUpdate:
        self._committed = ""
        self._ghost = ""
        self._debounce_armed = False
        self._last_update = self._clock()
        return self._update(None)
