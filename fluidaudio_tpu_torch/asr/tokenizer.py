"""SentencePiece-style vocabulary: id<->piece mapping + text assembly.

Behavioral parity: reference `Streaming/Tokenizer.swift` (vocab.json tokenizer)
and `AsrManager.swift:508-515` (vocabulary -> text: `▁` -> space). Encoding
(needed by custom-vocabulary boosting) is greedy longest-match over pieces.
"""

from __future__ import annotations

import json
from pathlib import Path

from fluidaudio_tpu_torch.asr.constants import ASRConstants

_WB = ASRConstants.SENTENCEPIECE_WORD_BOUNDARY


class Tokenizer:
    def __init__(
        self,
        vocabulary: dict[int, str],
        scores: dict[int, float] | None = None,
        byte_ids: set[int] | None = None,
    ):
        self.vocabulary = dict(vocabulary)
        self.scores = dict(scores) if scores else None
        self.byte_ids = set(byte_ids) if byte_ids else set()
        self._piece_to_id = {p: i for i, p in self.vocabulary.items()}
        self._max_piece_len = max((len(p) for p in self._piece_to_id), default=0)

    @classmethod
    def from_sentencepiece(cls, path: str | Path) -> "Tokenizer":
        """Load directly from a SentencePiece binary `.model` (ModelProto) —
        the asset NeMo checkpoints ship; no sentencepiece package needed."""
        from fluidaudio_tpu_torch.asr.sentencepiece_model import BYTE, load_model

        model = load_model(path)
        byte_ids = {i for i, p in enumerate(model.pieces) if p.type == BYTE}
        return cls(model.vocabulary, scores=model.scores, byte_ids=byte_ids)

    @classmethod
    def from_json(cls, path: str | Path) -> "Tokenizer":
        raw = json.loads(Path(path).read_text())
        # accept {"piece": id} or {"id": "piece"}
        first_key = next(iter(raw)) if raw else ""
        if first_key.lstrip("-").isdigit():
            vocab = {int(k): v for k, v in raw.items()}
        else:
            vocab = {int(v): k for k, v in raw.items()}
        return cls(vocab)

    def decode(self, ids: list[int]) -> str:
        if self.byte_ids:
            # byte fallback pieces ("<0xAB>") combine into utf-8 sequences
            chunks: list[str] = []
            pending: bytearray = bytearray()
            for i in ids:
                if i in self.byte_ids:
                    pending.append(int(self.vocabulary[i][1:-1], 16))
                else:
                    if pending:
                        chunks.append(pending.decode("utf-8", errors="replace"))
                        pending = bytearray()
                    chunks.append(self.vocabulary.get(i, ""))
            if pending:
                chunks.append(pending.decode("utf-8", errors="replace"))
            text = "".join(chunks).replace(_WB, " ")
        else:
            pieces = [self.vocabulary.get(i, "") for i in ids]
            text = "".join(pieces).replace(_WB, " ")
        return text.strip()

    def piece(self, token_id: int) -> str:
        return self.vocabulary.get(token_id, "")

    def encode_word(self, word: str, word_initial: bool = True) -> list[int] | None:
        """Encode one word; None if not representable. With unigram scores
        (from a binary .model) uses Viterbi segmentation like sentencepiece;
        otherwise greedy longest-match."""
        text = (_WB if word_initial else "") + word
        if self.scores is not None:
            from fluidaudio_tpu_torch.asr.sentencepiece_model import viterbi_encode

            return viterbi_encode(
                text, self._piece_to_id, self.scores,
                max_piece_len=self._max_piece_len,
            )
        out: list[int] = []
        pos = 0
        while pos < len(text):
            match = None
            for ln in range(min(self._max_piece_len, len(text) - pos), 0, -1):
                cand = text[pos : pos + ln]
                if cand in self._piece_to_id:
                    match = cand
                    break
            if match is None:
                return None
            out.append(self._piece_to_id[match])
            pos += len(match)
        return out

    def __len__(self) -> int:
        return len(self.vocabulary)
