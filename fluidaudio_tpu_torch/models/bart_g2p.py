"""BART encoder-decoder for English G2P, in PyTorch.

Port of `fluidaudio_tpu/models/bart_g2p.py` (reference
`TTS/G2P/G2PModel.swift:6`: grapheme ids -> BOS/EOS-framed encode, greedy
decode to phoneme ids), HF `BartForConditionalGeneration` semantics:

  - learned positional embeddings with BART's +2 offset
  - post-norm layers (residual -> LayerNorm, flax eps 1e-6),
    `layernorm_embedding` after token+position embeddings
  - attention scaling 1/sqrt(head_dim) applied to q, masked scores filled
    with the dtype's min before an f32 softmax
  - exact (erf) GELU, biased projections
  - lm_head = shared embedding transposed + final_logits_bias

Module and parameter names mirror the flax tree, so `utils.weights.load_npz`
maps a JAX-saved `bart.npz` directly. `config_from_hf` is
`convert/bart.py`'s (as in JAX), re-exported here.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F


@dataclass(frozen=True)
class BartConfig:
    vocab_size: int = 100
    d_model: int = 256
    encoder_layers: int = 3
    decoder_layers: int = 3
    encoder_attention_heads: int = 4
    decoder_attention_heads: int = 4
    encoder_ffn_dim: int = 1024
    decoder_ffn_dim: int = 1024
    max_position_embeddings: int = 128
    scale_embedding: bool = False
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2
    decoder_start_token_id: int = 2  # HF BART starts decode with EOS


BART_G2P_TEST = BartConfig(vocab_size=80, d_model=64, encoder_layers=2,
                           decoder_layers=2, encoder_attention_heads=4,
                           decoder_attention_heads=4, encoder_ffn_dim=128,
                           decoder_ffn_dim=128, max_position_embeddings=64)


class _Embed(nn.Module):
    """flax `nn.Embed`: the table is `embedding` [V, D]."""

    def __init__(self, n: int, d: int, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(n, d, device=device))


class BartAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, device=None):
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = nn.Linear(d_model, d_model, device=device)
        self.k_proj = nn.Linear(d_model, d_model, device=device)
        self.v_proj = nn.Linear(d_model, d_model, device=device)
        self.out_proj = nn.Linear(d_model, d_model, device=device)

    def forward(self, q_in, kv_in, mask):
        B, Tq, D = q_in.shape
        Tk = kv_in.shape[1]
        H = self.n_heads
        Dh = D // H
        q = (self.q_proj(q_in) * (Dh ** -0.5)).reshape(B, Tq, H, Dh)
        k = self.k_proj(kv_in).reshape(B, Tk, H, Dh)
        v = self.v_proj(kv_in).reshape(B, Tk, H, Dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores.float(), -1).to(scores.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, Tq, D)
        return self.out_proj(out)


class BartG2P(nn.Module):
    def __init__(self, cfg: BartConfig = BART_G2P_TEST, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.shared = _Embed(cfg.vocab_size, D, device)
        self.enc_pos = _Embed(cfg.max_position_embeddings + 2, D, device)
        self.dec_pos = _Embed(cfg.max_position_embeddings + 2, D, device)
        self.enc_emb_ln = nn.LayerNorm(D, eps=1e-6, device=device)
        self.dec_emb_ln = nn.LayerNorm(D, eps=1e-6, device=device)
        for i in range(cfg.encoder_layers):
            self.add_module(f"enc{i}_attn", BartAttention(D, cfg.encoder_attention_heads, device))
            self.add_module(f"enc{i}_attn_ln", nn.LayerNorm(D, eps=1e-6, device=device))
            self.add_module(f"enc{i}_fc1", nn.Linear(D, cfg.encoder_ffn_dim, device=device))
            self.add_module(f"enc{i}_fc2", nn.Linear(cfg.encoder_ffn_dim, D, device=device))
            self.add_module(f"enc{i}_final_ln", nn.LayerNorm(D, eps=1e-6, device=device))
        for i in range(cfg.decoder_layers):
            self.add_module(f"dec{i}_self", BartAttention(D, cfg.decoder_attention_heads, device))
            self.add_module(f"dec{i}_self_ln", nn.LayerNorm(D, eps=1e-6, device=device))
            self.add_module(f"dec{i}_cross", BartAttention(D, cfg.decoder_attention_heads, device))
            self.add_module(f"dec{i}_cross_ln", nn.LayerNorm(D, eps=1e-6, device=device))
            self.add_module(f"dec{i}_fc1", nn.Linear(D, cfg.decoder_ffn_dim, device=device))
            self.add_module(f"dec{i}_fc2", nn.Linear(cfg.decoder_ffn_dim, D, device=device))
            self.add_module(f"dec{i}_final_ln", nn.LayerNorm(D, eps=1e-6, device=device))
        self.final_logits_bias = nn.Parameter(torch.zeros(cfg.vocab_size, device=device))

    def _layer(self, name: str) -> nn.Module:
        return getattr(self, name)

    def _embed(self, ids, pos_table: _Embed, emb_ln: nn.LayerNorm):
        scale = self.cfg.d_model ** 0.5 if self.cfg.scale_embedding else 1.0
        x = F.embedding(ids, self.shared.embedding) * scale
        pos = torch.arange(ids.shape[1], device=ids.device) + 2  # BART's legacy offset
        return emb_ln(x + pos_table.embedding[pos][None])

    def encode(self, enc_ids, enc_mask):
        x = self._embed(enc_ids, self.enc_pos, self.enc_emb_ln)
        m = enc_mask[:, None, None, :]
        for i in range(self.cfg.encoder_layers):
            L = lambda n: self._layer(f"enc{i}_{n}")  # noqa: E731
            x = L("attn_ln")(x + L("attn")(x, x, m))
            x = L("final_ln")(x + L("fc2")(F.gelu(L("fc1")(x))))
        return x

    def decode(self, enc_out, enc_mask, dec_ids):
        x = self._embed(dec_ids, self.dec_pos, self.dec_emb_ln)
        Td = dec_ids.shape[1]
        causal = torch.tril(torch.ones((Td, Td), dtype=torch.bool, device=x.device))[None, None]
        cm = enc_mask[:, None, None, :]
        for i in range(self.cfg.decoder_layers):
            L = lambda n: self._layer(f"dec{i}_{n}")  # noqa: E731
            x = L("self_ln")(x + L("self")(x, x, causal))
            x = L("cross_ln")(x + L("cross")(x, enc_out, cm))
            x = L("final_ln")(x + L("fc2")(F.gelu(L("fc1")(x))))
        return x @ self.shared.embedding.T + self.final_logits_bias

    def forward(self, enc_ids, enc_mask, dec_ids):
        return self.decode(self.encode(enc_ids, enc_mask), enc_mask, dec_ids)


@torch.no_grad()
def bart_greedy_decode(model: BartG2P, enc_ids: torch.Tensor, enc_mask: torch.Tensor,
                       max_steps: int = 32) -> torch.Tensor:
    """Batched greedy decode, JAX's `lax.scan` of `max_steps` as fixed steps
    on the device with a done-mask (no host read inside). HF BART generation
    starts with [decoder_start(=EOS), BOS]; rows stop at EOS and pad after.
    -> [B, max_steps] ids following the BOS."""
    cfg = model.cfg
    enc_out = model.encode(enc_ids, enc_mask)
    B = enc_ids.shape[0]
    dev = enc_ids.device
    dec = torch.full((B, max_steps + 2), cfg.pad_token_id, dtype=torch.int64, device=dev)
    dec[:, 0] = cfg.decoder_start_token_id
    dec[:, 1] = cfg.bos_token_id
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for t in range(max_steps):
        # the whole (causal) buffer each step, as JAX's scan body does
        logits = model.decode(enc_out, enc_mask, dec[:, :-1])
        tok = torch.argmax(logits[:, t + 1], dim=-1)
        tok = torch.where(done, torch.full_like(tok, cfg.pad_token_id), tok)
        dec[:, t + 2] = tok
        done = done | (tok == cfg.eos_token_id)
    return dec[:, 2:]


def __getattr__(name: str):
    # `convert/bart.py` imports this module's config, so the converter's
    # `config_from_hf` is re-exported lazily
    if name == "config_from_hf":
        from fluidaudio_tpu_torch.convert.bart import config_from_hf

        return config_from_hf
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
