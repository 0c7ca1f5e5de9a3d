"""Shared phoneme-string chunker for TTS frontends.

Behavioral parity: reference `TTS/Shared/PhonemeChunker.swift` (issue #712)
— split an already-phonemized string into chunks of at most `max_length`
characters, breaking at the LATEST whitespace or pause-punctuation boundary
inside each window so words stay intact and punctuation stays attached to
the preceding chunk; runs longer than the cap with no boundary hard-split
at the cap. Used by KokoroManager and StyleTTS2Manager for long
multi-sentence input.
"""

from __future__ import annotations

DEFAULT_BOUNDARY_PUNCTUATION = frozenset(",.;:!?…—")


def chunk_phonemes(
    phonemes: str,
    max_length: int,
    boundary_punctuation: frozenset[str] = DEFAULT_BOUNDARY_PUNCTUATION,
) -> list[str]:
    """-> [] for blank input; [trimmed] when it fits; ordered chunks else."""
    text = phonemes.strip()
    if not text:
        return []
    if len(text) <= max_length:
        return [text]

    chunks: list[str] = []
    pos = 0
    n = len(text)
    while pos < n:
        remaining = n - pos
        if remaining <= max_length:
            tail = text[pos:].strip()
            if tail:
                chunks.append(tail)
            break
        window = text[pos : pos + max_length]
        if text[pos + max_length].isspace():
            # the full window ends exactly at a word boundary
            cut = max_length
        else:
            # latest boundary in the window: whitespace, or pause punctuation
            # (break AFTER the punctuation so it stays with the chunk)
            cut = -1
            for i in range(len(window) - 1, -1, -1):
                ch = window[i]
                if ch.isspace():
                    cut = i
                    break
                if ch in boundary_punctuation:
                    cut = i + 1
                    break
            if cut <= 0:
                cut = max_length  # no boundary: hard split at the cap
        piece = text[pos : pos + cut].strip()
        if piece:
            chunks.append(piece)
        pos += cut
        while pos < n and text[pos].isspace():
            pos += 1
    return chunks
