"""ByT5 encoder-decoder for multilingual G2P (CharsiuG2P parity), in PyTorch.

Port of `fluidaudio_tpu/models/byt5_g2p.py` (reference
`TTS/G2P/MultilingualG2PModel.swift:9`: byte-level T5, per-language
"<lang>: " prompt, greedy decode), T5-v1.1 semantics:

  - T5LayerNorm = RMS norm (no mean subtraction, no bias), eps 1e-6, the
    variance in f32
  - attention without 1/sqrt(d_kv) scaling
  - relative position bias only on the FIRST self-attention layer of the
    encoder and of the decoder, shared by the rest
  - gated-GELU feed-forward (wi_0 gate * wi_1) with the tanh GELU
  - untied lm_head (a tied one rescales by d_model**-0.5)

`relative_position_bucket` computes in JAX's order and dtypes (an f32 log
of n / max_exact + 1e-9, divided by the f64 log ratio rounded to f32,
truncated to int32), so every bucket equals JAX's. Module and parameter
names mirror the flax tree (`enc<i>_attn`, `dec<i>_self`, ...), so
`utils.weights.load_npz` maps a JAX-saved `byt5.npz` directly.
`config_from_hf` is the JAX package's `convert/byt5.py::config_from_hf`.

`byt5_greedy_decode` runs JAX's `lax.scan` of `max_steps` as fixed steps on
the device (the whole decoder over the buffer each step, a done-mask, no
host read inside).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from fluidaudio_tpu_torch.models.kokoro import _Embed

PAD_ID = 0
EOS_ID = 1


@dataclass(frozen=True)
class ByT5Config:
    vocab_size: int = 384
    d_model: int = 1472
    d_kv: int = 64
    d_ff: int = 3584
    num_layers: int = 12
    num_decoder_layers: int = 4
    num_heads: int = 6
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    tie_word_embeddings: bool = False


# charsiu/g2p_multilingual_byT5_small_100 uses the stock byt5-small dims
BYT5_SMALL = ByT5Config()
BYT5_TEST = ByT5Config(
    vocab_size=384, d_model=64, d_kv=16, d_ff=128, num_layers=2,
    num_decoder_layers=2, num_heads=4, relative_attention_num_buckets=8,
    relative_attention_max_distance=20,
)


def config_from_hf(cfg_json: dict) -> ByT5Config:
    """Build a ByT5Config from an HF `config.json` payload."""
    return ByT5Config(
        vocab_size=cfg_json["vocab_size"],
        d_model=cfg_json["d_model"],
        d_kv=cfg_json["d_kv"],
        d_ff=cfg_json["d_ff"],
        num_layers=cfg_json["num_layers"],
        num_decoder_layers=cfg_json.get("num_decoder_layers",
                                        cfg_json["num_layers"]),
        num_heads=cfg_json["num_heads"],
        relative_attention_num_buckets=cfg_json.get(
            "relative_attention_num_buckets", 32),
        relative_attention_max_distance=cfg_json.get(
            "relative_attention_max_distance", 128),
        layer_norm_epsilon=cfg_json.get("layer_norm_epsilon", 1e-6),
        tie_word_embeddings=cfg_json.get("tie_word_embeddings", False),
    )


def _gelu_new(x: torch.Tensor) -> torch.Tensor:
    # HF "gelu_new": tanh approximation, JAX's formula
    return 0.5 * x * (1.0 + torch.tanh(
        np.float32(np.sqrt(2.0 / np.pi)) * (x + 0.044715 * torch.pow(x, 3.0))))


class T5LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


def relative_position_bucket(rel_pos: torch.Tensor, *, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF `T5Attention._relative_position_bucket`, JAX's arithmetic: int32
    positions, the large-distance branch in f32."""
    rel_pos = rel_pos.to(torch.int32)
    ret = torch.zeros_like(rel_pos)
    n = -rel_pos
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = torch.abs(n)
    else:
        n = torch.clamp(n, min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = np.float32(np.log(max_distance / max_exact))
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + np.float32(1e-9))
        / log_ratio
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: ByT5Config, has_relative_bias: bool = False,
                 bidirectional: bool = True, device=None):
        super().__init__()
        self.cfg, self.has_relative_bias, self.bidirectional = cfg, has_relative_bias, bidirectional
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False, device=device)
        self.k = nn.Linear(cfg.d_model, inner, bias=False, device=device)
        self.v = nn.Linear(cfg.d_model, inner, bias=False, device=device)
        if has_relative_bias:
            self.relative_attention_bias = _Embed(cfg.relative_attention_num_buckets,
                                                  cfg.num_heads, device)
        self.o = nn.Linear(inner, cfg.d_model, bias=False, device=device)

    def forward(self, q_in, kv_in, mask, position_bias=None):
        cfg = self.cfg
        B, Tq, _ = q_in.shape
        Tk = kv_in.shape[1]
        H, Dk = cfg.num_heads, cfg.d_kv
        q = self.q(q_in).reshape(B, Tq, H, Dk)
        k = self.k(kv_in).reshape(B, Tk, H, Dk)
        v = self.v(kv_in).reshape(B, Tk, H, Dk)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)  # NO 1/sqrt(d_kv)
        if self.has_relative_bias:
            ctx = torch.arange(Tq, device=q_in.device)[:, None]
            mem = torch.arange(Tk, device=q_in.device)[None, :]
            buckets = relative_position_bucket(
                mem - ctx, bidirectional=self.bidirectional,
                num_buckets=cfg.relative_attention_num_buckets,
                max_distance=cfg.relative_attention_max_distance)
            table = F.embedding(buckets.long(), self.relative_attention_bias.embedding)
            position_bias = table.permute(2, 0, 1)[None]  # [1, H, Tq, Tk]
        if position_bias is not None:
            scores = scores + position_bias
        if mask is not None:
            scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, Tq, H * Dk)
        return self.o(out), position_bias


class T5FFN(nn.Module):
    def __init__(self, cfg: ByT5Config, device=None):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, device=device)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, device=device)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, device=device)

    def forward(self, x):
        return self.wo(_gelu_new(self.wi_0(x)) * self.wi_1(x))


class ByT5G2P(nn.Module):
    """T5 stack; `forward(enc_ids, enc_mask, dec_ids)` -> decoder logits."""

    def __init__(self, cfg: ByT5Config = BYT5_SMALL, device=None):
        super().__init__()
        self.cfg = cfg
        eps = cfg.layer_norm_epsilon
        self.shared = _Embed(cfg.vocab_size, cfg.d_model, device)
        for i in range(cfg.num_layers):
            self.add_module(f"enc{i}_attn_ln", T5LayerNorm(cfg.d_model, eps, device))
            self.add_module(f"enc{i}_attn", T5Attention(cfg, i == 0, True, device))
            self.add_module(f"enc{i}_ffn_ln", T5LayerNorm(cfg.d_model, eps, device))
            self.add_module(f"enc{i}_ffn", T5FFN(cfg, device))
        self.enc_final_ln = T5LayerNorm(cfg.d_model, eps, device)
        for i in range(cfg.num_decoder_layers):
            self.add_module(f"dec{i}_self_ln", T5LayerNorm(cfg.d_model, eps, device))
            self.add_module(f"dec{i}_self", T5Attention(cfg, i == 0, False, device))
            self.add_module(f"dec{i}_cross_ln", T5LayerNorm(cfg.d_model, eps, device))
            self.add_module(f"dec{i}_cross", T5Attention(cfg, False, True, device))
            self.add_module(f"dec{i}_ffn_ln", T5LayerNorm(cfg.d_model, eps, device))
            self.add_module(f"dec{i}_ffn", T5FFN(cfg, device))
        self.dec_final_ln = T5LayerNorm(cfg.d_model, eps, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False, device=device)

    def encode(self, enc_ids: torch.Tensor, enc_mask: torch.Tensor) -> torch.Tensor:
        x = F.embedding(enc_ids.long(), self.shared.embedding)
        attn_mask = enc_mask.bool()[:, None, None, :]
        bias = None
        for i in range(self.cfg.num_layers):
            L = lambda n: getattr(self, f"enc{i}_{n}")  # noqa: E731
            ln_x = L("attn_ln")(x)
            h, bias = L("attn")(ln_x, ln_x, attn_mask, bias)
            x = x + h
            x = x + L("ffn")(L("ffn_ln")(x))
        return self.enc_final_ln(x)

    def decode(self, enc_out: torch.Tensor, enc_mask: torch.Tensor,
               dec_ids: torch.Tensor) -> torch.Tensor:
        Td = dec_ids.shape[1]
        x = F.embedding(dec_ids.long(), self.shared.embedding)
        causal = torch.tril(torch.ones((Td, Td), dtype=torch.bool, device=x.device))[None, None]
        cross_mask = enc_mask.bool()[:, None, None, :]
        bias = None
        for i in range(self.cfg.num_decoder_layers):
            L = lambda n: getattr(self, f"dec{i}_{n}")  # noqa: E731
            ln_x = L("self_ln")(x)
            h, bias = L("self")(ln_x, ln_x, causal, bias)
            x = x + h
            h, _ = L("cross")(L("cross_ln")(x), enc_out, cross_mask)
            x = x + h
            x = x + L("ffn")(L("ffn_ln")(x))
        x = self.dec_final_ln(x)
        if self.cfg.tie_word_embeddings:
            return (x * (self.cfg.d_model ** -0.5)) @ self.shared.embedding.T
        return self.lm_head(x)

    def forward(self, enc_ids, enc_mask, dec_ids):
        return self.decode(self.encode(enc_ids, enc_mask), enc_mask, dec_ids)


def encode_bytes(text: str, max_len: int) -> tuple[np.ndarray, int]:
    """ByT5 ids: utf-8 byte + 3, then EOS; padded with PAD_ID."""
    raw = list(text.encode("utf-8"))[: max_len - 1]
    ids = [b + 3 for b in raw] + [EOS_ID]
    n = len(ids)
    return np.asarray(ids + [PAD_ID] * (max_len - n), np.int32), n


def decode_bytes(ids) -> str:
    out = bytearray()
    for i in ids:
        i = int(i)
        if i == EOS_ID:
            break
        if 3 <= i < 259:  # ids >= 259 are ByT5 sentinel tokens — skip
            out.append(i - 3)
    return out.decode("utf-8", errors="ignore")


@torch.no_grad()
def byt5_greedy_decode(model: ByT5G2P, enc_ids: torch.Tensor, enc_mask: torch.Tensor,
                       max_steps: int = 48) -> torch.Tensor:
    """Batched greedy decode -> [B, max_steps] token ids (EOS-terminated
    rows, PAD after)."""
    enc_out = model.encode(enc_ids, enc_mask)
    B = enc_ids.shape[0]
    dec = torch.zeros((B, max_steps + 1), dtype=torch.int64, device=enc_ids.device)
    done = torch.zeros((B,), dtype=torch.bool, device=enc_ids.device)
    for t in range(max_steps):
        logits = model.decode(enc_out, enc_mask, dec[:, :-1])
        tok = torch.argmax(logits[:, t], dim=-1)
        tok = torch.where(done, torch.full_like(tok, PAD_ID), tok)
        dec[:, t + 1] = tok
        done = done | (tok == EOS_ID)
    return dec[:, 1:]
