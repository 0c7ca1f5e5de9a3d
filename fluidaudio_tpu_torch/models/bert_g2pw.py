"""BERT-base polyphone classifier for Mandarin G2P (g2pW parity), in PyTorch.

Port of `fluidaudio_tpu/models/bert_g2pw.py` (reference
`KokoroAne/G2P/Mandarin/MandarinG2pwModel.swift:3-38`): given a tokenized
sentence and the position of one target Hanzi, logits over the global
polyphone label set. HF `BertModel` semantics:

  - embeddings: word + absolute position + token_type, then LayerNorm
  - post-norm encoder layers (residual -> LayerNorm, eps 1e-12), exact
    (erf) GELU intermediate
  - attention with 1/sqrt(head_dim) score scaling, biased projections,
    masked scores replaced by the dtype's min
  - head: hidden[target_position] -> Linear(num_labels)

Module and parameter names mirror the flax tree, so `utils.weights.load_npz`
maps a JAX-saved `g2pw.npz` directly. `config_from_hf` is the JAX package's
`convert/g2pw.py::config_from_hf`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from fluidaudio_tpu_torch.models.kokoro import _Embed


@dataclass(frozen=True)
class BertG2pwConfig:
    vocab_size: int = 21128  # bert-base-chinese
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    num_labels: int = 700  # polyphone label set


G2PW_BASE = BertG2pwConfig()
G2PW_TEST = BertG2pwConfig(vocab_size=128, hidden_size=32,
                           num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=64, max_position_embeddings=64,
                           num_labels=16)


def config_from_hf(cfg_json: dict, num_labels: int | None = None) -> BertG2pwConfig:
    """An HF BERT `config.json` payload -> BertG2pwConfig."""
    return BertG2pwConfig(
        vocab_size=cfg_json["vocab_size"],
        hidden_size=cfg_json["hidden_size"],
        num_hidden_layers=cfg_json["num_hidden_layers"],
        num_attention_heads=cfg_json["num_attention_heads"],
        intermediate_size=cfg_json["intermediate_size"],
        max_position_embeddings=cfg_json["max_position_embeddings"],
        type_vocab_size=cfg_json.get("type_vocab_size", 2),
        layer_norm_eps=cfg_json.get("layer_norm_eps", 1e-12),
        num_labels=num_labels or cfg_json.get("num_labels", 700),
    )


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertG2pwConfig, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.query = nn.Linear(d, d, device=device)
        self.key = nn.Linear(d, d, device=device)
        self.value = nn.Linear(d, d, device=device)
        self.out = nn.Linear(d, d, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        B, T, d = x.shape
        H = self.heads
        Dh = d // H
        q = self.query(x).reshape(B, T, H, Dh)
        k = self.key(x).reshape(B, T, H, Dh)
        v = self.value(x).reshape(B, T, H, Dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
        if mask is not None:
            scores = torch.where(mask[:, None, None, :], scores,
                                 torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, d))


class BertG2pw(nn.Module):
    """`forward(input_ids, attention_mask, token_type_ids, target_position)`
    -> polyphone logits [B, num_labels]."""

    def __init__(self, cfg: BertG2pwConfig = G2PW_BASE, device=None):
        super().__init__()
        self.cfg = cfg
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.word_emb = _Embed(cfg.vocab_size, d, device)
        self.pos_emb = _Embed(cfg.max_position_embeddings, d, device)
        self.type_emb = _Embed(cfg.type_vocab_size, d, device)
        self.emb_ln = nn.LayerNorm(d, eps=eps, device=device)
        for i in range(cfg.num_hidden_layers):
            self.add_module(f"layer{i}_attn", BertSelfAttention(cfg, device))
            self.add_module(f"layer{i}_attn_ln", nn.LayerNorm(d, eps=eps, device=device))
            self.add_module(f"layer{i}_ffn_in", nn.Linear(d, cfg.intermediate_size, device=device))
            self.add_module(f"layer{i}_ffn_out", nn.Linear(cfg.intermediate_size, d,
                                                           device=device))
            self.add_module(f"layer{i}_ffn_ln", nn.LayerNorm(d, eps=eps, device=device))
        self.classifier = nn.Linear(d, cfg.num_labels, device=device)

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor, target_position: torch.Tensor) -> torch.Tensor:
        T = input_ids.shape[1]
        pos_rows = self.pos_emb.embedding[:T]
        if T > pos_rows.shape[0]:  # flax's Embed gives NaN rows past its table
            pos_rows = torch.cat([pos_rows, pos_rows.new_full((T - pos_rows.shape[0],
                                                               pos_rows.shape[1]), float("nan"))])
        x = (F.embedding(input_ids.long(), self.word_emb.embedding)
             + pos_rows[None]
             + F.embedding(token_type_ids.long(), self.type_emb.embedding))
        x = self.emb_ln(x)
        mask = attention_mask.bool()
        for i in range(self.cfg.num_hidden_layers):
            L = lambda n: getattr(self, f"layer{i}_{n}")  # noqa: E731
            x = L("attn_ln")(x + L("attn")(x, mask))
            h = L("ffn_out")(F.gelu(L("ffn_in")(x)))
            x = L("ffn_ln")(x + h)
        idx = target_position.long()[:, None, None].expand(-1, 1, x.shape[-1])
        return self.classifier(torch.take_along_dim(x, idx, dim=1)[:, 0])
