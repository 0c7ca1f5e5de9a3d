"""SentencePiece binary `.model` (ModelProto) reader/writer — no deps.

NeMo checkpoints ship their tokenizer as a SentencePiece protobuf; the
reference loads it through the sentencepiece C++ library (vocab extracted at
model-conversion time into `vocab.json`, see reference
`Streaming/Tokenizer.swift`). Here we parse the protobuf wire format directly
so the JAX package's converters (`fluidaudio_tpu.convert`) can ingest NeMo
assets without the sentencepiece package: only the `pieces` field matters for inference (id -> piece, score,
type), and unigram scores enable a Viterbi encoder that matches
sentencepiece's segmentation (unlike greedy longest-match).

Wire subset implemented: varint / 64-bit / length-delimited / 32-bit fields;
ModelProto field 1 = repeated SentencePiece{piece=1 (string), score=2
(float32), type=3 (enum)}. Other top-level fields (TrainerSpec=2,
NormalizerSpec=3, ...) are skipped structurally.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

# SentencePiece.Type enum values (sentencepiece_model.proto)
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6


@dataclass
class Piece:
    piece: str
    score: float = 0.0
    type: int = NORMAL


@dataclass
class SentencePieceModel:
    pieces: list[Piece] = field(default_factory=list)

    @property
    def vocabulary(self) -> dict[int, str]:
        return {i: p.piece for i, p in enumerate(self.pieces)}

    @property
    def scores(self) -> dict[int, float]:
        return {i: p.score for i, p in enumerate(self.pieces)}


# ------------------------------------------------------------- wire format

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message.

    value: int for varint, bytes for length-delimited, raw 4/8 bytes for
    fixed32/fixed64.
    """
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 0x7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val, pos = buf[pos : pos + 8], pos + 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos : pos + ln], pos + ln
            if len(val) != ln:
                raise ValueError("truncated length-delimited field")
        elif wtype == 5:  # 32-bit
            val, pos = buf[pos : pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _parse_piece(buf: bytes) -> Piece:
    out = Piece(piece="")
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1 and wtype == 2:
            out.piece = val.decode("utf-8")
        elif fnum == 2 and wtype == 5:
            out.score = struct.unpack("<f", val)[0]
        elif fnum == 3 and wtype == 0:
            out.type = int(val)
    return out


def parse_model(data: bytes) -> SentencePieceModel:
    model = SentencePieceModel()
    for fnum, wtype, val in _iter_fields(data):
        if fnum == 1 and wtype == 2:
            model.pieces.append(_parse_piece(val))
    return model


def load_model(path: str | Path) -> SentencePieceModel:
    return parse_model(Path(path).read_bytes())


def serialize_model(model: SentencePieceModel) -> bytes:
    """ModelProto writer (test fixtures + re-export of converted vocabs)."""
    out = bytearray()
    for p in model.pieces:
        body = bytearray()
        enc = p.piece.encode("utf-8")
        body += _write_varint((1 << 3) | 2) + _write_varint(len(enc)) + enc
        body += _write_varint((2 << 3) | 5) + struct.pack("<f", p.score)
        body += _write_varint((3 << 3) | 0) + _write_varint(p.type)
        out += _write_varint((1 << 3) | 2) + _write_varint(len(body)) + bytes(body)
    return bytes(out)


# --------------------------------------------------------- unigram viterbi

def viterbi_encode(
    text: str,
    piece_to_id: dict[str, int],
    scores: dict[int, float],
    max_piece_len: int = 16,
) -> list[int] | None:
    """Unigram-LM Viterbi segmentation (max total log-prob), as sentencepiece
    does — differs from greedy longest-match when a shorter first piece
    enables a higher-scoring remainder. None if any prefix is uncoverable."""
    n = len(text)
    NEG = float("-inf")
    best = [NEG] * (n + 1)
    back: list[tuple[int, int] | None] = [None] * (n + 1)
    best[0] = 0.0
    for i in range(n):
        if best[i] == NEG:
            continue
        for ln in range(1, min(max_piece_len, n - i) + 1):
            cand = text[i : i + ln]
            pid = piece_to_id.get(cand)
            if pid is None:
                continue
            s = best[i] + scores.get(pid, 0.0)
            if s > best[i + ln]:
                best[i + ln] = s
                back[i + ln] = (i, pid)
    if best[n] == NEG:
        return None
    ids: list[int] = []
    pos = n
    while pos > 0:
        i, pid = back[pos]  # type: ignore[misc]
        ids.append(pid)
        pos = i
    return ids[::-1]
