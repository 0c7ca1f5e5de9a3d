"""BK-tree over Levenshtein distance for fuzzy candidate lookup.

Behavioral parity: reference `CustomVocabulary/BKTree/BKTree.swift` (125 LoC).
"""

from __future__ import annotations


def _edit_distance(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


class _Node:
    __slots__ = ("word", "payload", "children")

    def __init__(self, word: str, payload):
        self.word = word
        self.payload = payload
        self.children: dict[int, _Node] = {}


class BKTree:
    def __init__(self):
        self._root: _Node | None = None
        self._size = 0

    def insert(self, word: str, payload=None) -> None:
        word = word.lower()
        if self._root is None:
            self._root = _Node(word, payload)
            self._size = 1
            return
        node = self._root
        while True:
            d = _edit_distance(word, node.word)
            if d == 0:
                node.payload = payload
                return
            child = node.children.get(d)
            if child is None:
                node.children[d] = _Node(word, payload)
                self._size += 1
                return
            node = child

    def search(self, word: str, max_distance: int) -> list[tuple[str, int, object]]:
        """All entries within max_distance: [(word, distance, payload)] sorted."""
        if self._root is None:
            return []
        word = word.lower()
        out: list[tuple[str, int, object]] = []
        stack = [self._root]
        while stack:
            node = stack.pop()
            d = _edit_distance(word, node.word)
            if d <= max_distance:
                out.append((node.word, d, node.payload))
            lo, hi = d - max_distance, d + max_distance
            for dist, child in node.children.items():
                if lo <= dist <= hi:
                    stack.append(child)
        out.sort(key=lambda x: x[1])
        return out

    def __len__(self) -> int:
        return self._size
