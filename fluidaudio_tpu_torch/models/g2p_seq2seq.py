"""Byte-level G2P seq2seq (charsiu ByT5 / BART analog), in PyTorch.

Port of `fluidaudio_tpu/models/g2p_seq2seq.py` (reference
`G2P/MultilingualG2PModel.swift:9`): word bytes in -> IPA codepoint ids out,
greedy decode. Pre-norm encoder/decoder blocks of flax's own layers
(LayerNorm eps 1e-6, `nn.SelfAttention` / `MultiHeadDotProductAttention`,
tanh GELU), learned positions.

The flax module keeps its blocks in `setup` lists of tuples, so its
parameters are named `enc_blocks_<layer>_<slot>` / `dec_blocks_<layer>_<slot>`
(slots in tuple order); the modules here carry those names, and
`utils.weights.load_npz` maps a JAX-saved tree directly.

`g2p_greedy_decode` runs JAX's `lax.scan` as MAX_PHONEMES - 1 fixed steps on
the device: each step recomputes the decoder over the whole buffer (the
causal mask hides the positions not written yet), as JAX's scan body does,
and nothing is read back until the end.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from fluidaudio_tpu_torch.models.flax_attention import FlaxAttention
from fluidaudio_tpu_torch.models.kokoro import _Embed

MAX_WORD_BYTES = 32
MAX_PHONEMES = 48
BOS, EOS, PAD = 1, 2, 0


@dataclass(frozen=True)
class G2pConfig:
    byte_vocab: int = 384  # 256 bytes + language prefix tokens + specials
    phoneme_vocab: int = 256  # IPA codepoint table
    d_model: int = 256
    n_layers: int = 3
    n_heads: int = 4
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


G2P_BASE = G2pConfig()
G2P_TEST = G2pConfig(d_model=32, n_layers=1, n_heads=4, byte_vocab=300,
                     phoneme_vocab=64)


class G2pSeq2Seq(nn.Module):
    def __init__(self, cfg: G2pConfig = G2P_BASE, device=None):
        super().__init__()
        self.cfg = cfg
        D, H = cfg.d_model, cfg.n_heads
        self.src_embed = _Embed(cfg.byte_vocab, D, device)
        self.tgt_embed = _Embed(cfg.phoneme_vocab, D, device)
        self.src_pos = nn.Parameter(torch.zeros(MAX_WORD_BYTES, D, device=device))
        self.tgt_pos = nn.Parameter(torch.zeros(MAX_PHONEMES, D, device=device))

        def ln():
            return nn.LayerNorm(D, eps=1e-6, device=device)

        for i in range(cfg.n_layers):
            for j, m in enumerate((ln(), FlaxAttention(D, H, device), ln(),
                                   nn.Linear(D, 4 * D, device=device),
                                   nn.Linear(4 * D, D, device=device))):
                self.add_module(f"enc_blocks_{i}_{j}", m)
            for j, m in enumerate((ln(), FlaxAttention(D, H, device), ln(),
                                   FlaxAttention(D, H, device), ln(),
                                   nn.Linear(D, 4 * D, device=device),
                                   nn.Linear(4 * D, D, device=device))):
                self.add_module(f"dec_blocks_{i}_{j}", m)
        self.final_ln = ln()
        self.head = nn.Linear(D, cfg.phoneme_vocab, device=device)
        self.to(cfg.compute_dtype)

    def _block(self, kind: str, i: int) -> list[nn.Module]:
        n = 5 if kind == "enc" else 7
        return [getattr(self, f"{kind}_blocks_{i}_{j}") for j in range(n)]

    def encode(self, bytes_in: torch.Tensor, lengths: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        dt = self.cfg.compute_dtype
        N = bytes_in.shape[1]
        x = F.embedding(bytes_in.long(), self.src_embed.embedding) + self.src_pos[:N][None].to(dt)
        valid = torch.arange(N, device=bytes_in.device)[None, :] < lengths[:, None]
        att = valid[:, None, None, :] & valid[:, None, :, None]
        for i in range(self.cfg.n_layers):
            ln1, sa, ln2, ff1, ff2 = self._block("enc", i)
            x = x + sa(ln1(x), mask=att)
            x = x + ff2(F.gelu(ff1(ln2(x)), approximate="tanh"))
        return x, valid

    def decode_logits(self, tgt_tokens: torch.Tensor, enc: torch.Tensor,
                      enc_valid: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits over the whole target prefix."""
        dt = self.cfg.compute_dtype
        M = tgt_tokens.shape[1]
        y = F.embedding(tgt_tokens.long(), self.tgt_embed.embedding) + self.tgt_pos[:M][None].to(dt)
        causal = torch.tril(torch.ones((M, M), dtype=torch.bool, device=y.device))[None, None]
        cross = enc_valid[:, None, None, :]
        for i in range(self.cfg.n_layers):
            ln1, sa, ln2, ca, ln3, ff1, ff2 = self._block("dec", i)
            y = y + sa(ln1(y), mask=causal)
            y = y + ca(ln2(y), enc, mask=cross)
            y = y + ff2(F.gelu(ff1(ln3(y)), approximate="tanh"))
        return self.head(self.final_ln(y)).float()

    def forward(self, bytes_in, lengths, tgt_tokens):
        enc, enc_valid = self.encode(bytes_in, lengths)
        return self.decode_logits(tgt_tokens, enc, enc_valid)


@torch.no_grad()
def g2p_greedy_decode(model: G2pSeq2Seq, bytes_in: torch.Tensor, lengths: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode: (phoneme ids [B, MAX_PHONEMES], counts [B]), JAX's
    semantics to the token: a finished row stops advancing and writes PAD
    at its position (over its EOS) on every later step."""
    enc, enc_valid = model.encode(bytes_in, lengths)
    B = bytes_in.shape[0]
    dev = bytes_in.device
    tokens = torch.full((B, MAX_PHONEMES), PAD, dtype=torch.int64, device=dev)
    tokens[:, 0] = BOS
    pos = torch.ones((B,), dtype=torch.int64, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)
    for _ in range(MAX_PHONEMES - 1):
        logits = model.decode_logits(tokens, enc, enc_valid)
        nxt = torch.argmax(logits[rows, torch.clamp(pos - 1, min=0)], dim=-1)
        nxt = torch.where(done, torch.full_like(nxt, PAD), nxt)
        tokens[rows, pos] = nxt
        done = done | (nxt == EOS)
        pos = torch.where(done, pos, pos + 1)
    return tokens, pos


def encode_word(word: str, language_prefix: int | None = None) -> tuple[np.ndarray, int]:
    """Word -> byte id row [MAX_WORD_BYTES] (+ optional language token)."""
    ids = []
    if language_prefix is not None:
        ids.append(256 + language_prefix)
    ids.extend(b + 3 for b in word.encode("utf-8")[: MAX_WORD_BYTES - len(ids)])
    row = np.zeros(MAX_WORD_BYTES, np.int32)
    row[: len(ids)] = ids[:MAX_WORD_BYTES]
    return row, len(ids)
