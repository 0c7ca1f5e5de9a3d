"""PocketTTS streaming autoregressive TTS (flow-matching LM + Mimi), in PyTorch.

Port of `fluidaudio_tpu/models/pocket_tts.py` (reference
`PocketTTS/Pipeline/PocketTtsSynthesizer.swift:142-287,498-707`):

  - `FlowLm`: one decoder-only transformer (RMSNorm, RoPE, gated-SiLU MLP)
    with a per-layer KV cache over 512 positions; a step takes one embedded
    input at `position` and returns the final hidden state (the flow
    decoder's conditioning) and the EOS logit (threshold -4.0).
  - `FlowDecoder`: 8 Euler steps of a conditional velocity field (residual
    MLP over [latent, cond] with a sinusoidal time embedding), the initial
    noise scaled by sqrt(0.7).
  - the Mimi codec, `models/mimi.py`.

The KV cache is written at `position` with a one-hot select (no host
index), so a step is a pure function of device tensors. Parameter names
mirror the flax tree (`blk<i>`, `velocity/...`); flax's `RMSNorm` `scale`
loads as `weight`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from fluidaudio_tpu_torch.models.kokoro import _Embed
from fluidaudio_tpu_torch.models.mimi import (  # noqa: F401  (re-exported)
    FRAME_SAMPLES,
    MIMI_TEST,
    MimiConfig,
    MimiDecoder,
    MimiEncoder,
    rope,
)

SAMPLE_RATE = 24_000
LATENT_DIM = 32
KV_POSITIONS = 512
VOICE_PROMPT_FRAMES = 125
EOS_THRESHOLD = -4.0
EULER_STEPS = 8
TEMPERATURE = 0.7


@dataclass(frozen=True)
class PocketTtsConfig:
    vocab_size: int = 4001  # SentencePiece text tokens
    d_model: int = 1024
    n_layers: int = 6  # 24 for the `*_24l` packs
    n_heads: int = 16
    ff_hidden: int = 2816  # gated-SiLU hidden
    flow_blocks: int = 4
    flow_hidden: int = 1024
    max_frames: int = 250  # 20 s per generate call
    mimi: MimiConfig = field(default_factory=MimiConfig)
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


POCKET_BASE = PocketTtsConfig()
POCKET_TEST = PocketTtsConfig(
    vocab_size=64, d_model=32, n_layers=2, n_heads=4, ff_hidden=48,
    flow_blocks=2, flow_hidden=24, max_frames=16, mimi=MIMI_TEST,
)


class KvCache(NamedTuple):
    k: torch.Tensor  # [L, B, KV_POSITIONS, H, Dh]
    v: torch.Tensor


def init_kv(cfg: PocketTtsConfig, batch: int, device=None) -> KvCache:
    shape = (cfg.n_layers, batch, KV_POSITIONS, cfg.n_heads, cfg.head_dim)
    return KvCache(torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
                   torch.zeros(shape, dtype=cfg.compute_dtype, device=device))


class RMSNorm(nn.Module):
    """flax `nn.RMSNorm`: x * (rsqrt(mean(x^2) + eps) * scale), stats in f32."""

    def __init__(self, d: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, device=device))

    def forward(self, x):
        ms = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        return x * (torch.rsqrt(ms + self.eps) * self.weight).to(x.dtype)


class _KvBlock(nn.Module):
    """RMSNorm -> RoPE attention over the KV cache -> RMSNorm -> gated-SiLU MLP."""

    def __init__(self, cfg: PocketTtsConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.norm1 = RMSNorm(D, device=device)
        self.in_proj = nn.Linear(D, 3 * D, bias=False, device=device)
        self.out_proj = nn.Linear(D, D, bias=False, device=device)
        self.norm2 = RMSNorm(D, device=device)
        self.gate_in = nn.Linear(D, 2 * cfg.ff_hidden, bias=False, device=device)
        self.gate_out = nn.Linear(cfg.ff_hidden, D, bias=False, device=device)

    def forward(self, x, position, k_cache, v_cache):
        cfg = self.cfg
        B = x.shape[0]
        H, Dh = cfg.n_heads, cfg.head_dim
        q, k, v = self.in_proj(self.norm1(x)).chunk(3, dim=-1)
        q = rope(q.reshape(B, 1, H, Dh), position[:, None])
        k_new = rope(k.reshape(B, 1, H, Dh), position[:, None])  # [B, 1, H, Dh]
        v_new = v.reshape(B, 1, H, Dh)
        slots = torch.arange(KV_POSITIONS, device=x.device)[None, :]
        hit = (slots == position[:, None])[..., None, None]  # [B, S, 1, 1]
        k_i = torch.where(hit, k_new, k_cache)
        v_i = torch.where(hit, v_new, v_cache)
        causal = slots <= position[:, None]
        scores = torch.einsum("bqhd,bshd->bhqs", q, k_i) / np.float32(np.sqrt(Dh))
        scores = torch.where(causal[:, None, None, :], scores, torch.finfo(scores.dtype).min)
        probs = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        att = torch.einsum("bhqs,bshd->bqhd", probs, v_i).reshape(B, 1, cfg.d_model)
        x = x + self.out_proj(att)
        a, b = self.gate_in(self.norm2(x)).chunk(2, dim=-1)
        return x + self.gate_out(F.silu(a) * b), k_i, v_i


class FlowLm(nn.Module):
    """Decoder-only flow LM over [BOS | voice prompt latents | text tokens |
    generated latents]; a step returns (hidden, eos logit, kv')."""

    def __init__(self, cfg: PocketTtsConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.text_embed = _Embed(cfg.vocab_size, D, device)
        self.latent_embed = nn.Linear(cfg.mimi.latent_dim, D, bias=False, device=device)
        self.bos = nn.Parameter(torch.zeros(D, device=device))
        for i in range(cfg.n_layers):
            self.add_module(f"blk{i}", _KvBlock(cfg, device))
        self.out_norm = RMSNorm(D, device=device)
        self.eos_head = nn.Linear(D, 1, device=device)

    def embed_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens.long(), self.text_embed.embedding)

    def embed_latent(self, latent: torch.Tensor) -> torch.Tensor:
        return self.latent_embed(latent)

    def prefill(self, seq: torch.Tensor, kv: KvCache) -> tuple[torch.Tensor, KvCache]:
        """seq [B, n, D] at positions 0..n-1 in one causal pass -> (the last
        position's hidden [B, D], kv with slots 0..n-1 written)."""
        B, n, _ = seq.shape
        cfg = self.cfg
        H, Dh = cfg.n_heads, cfg.head_dim
        pos = torch.arange(n, device=seq.device)[None].expand(B, n)
        causal = pos[0][:, None] >= pos[0][None, :]
        h = seq
        new_k, new_v = [], []
        for i in range(cfg.n_layers):
            blk = getattr(self, f"blk{i}")
            q, k, v = blk.in_proj(blk.norm1(h)).chunk(3, dim=-1)
            q = rope(q.reshape(B, n, H, Dh), pos)
            k = rope(k.reshape(B, n, H, Dh), pos)
            v = v.reshape(B, n, H, Dh)
            scores = torch.einsum("bqhd,bshd->bhqs", q, k) / np.float32(np.sqrt(Dh))
            scores = torch.where(causal, scores, torch.finfo(scores.dtype).min)
            probs = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
            h = h + blk.out_proj(torch.einsum("bhqs,bshd->bqhd", probs, v).reshape(B, n, -1))
            a, b = blk.gate_in(blk.norm2(h)).chunk(2, dim=-1)
            h = h + blk.gate_out(F.silu(a) * b)
            new_k.append(torch.cat([k, kv.k[i][:, n:]], dim=1))
            new_v.append(torch.cat([v, kv.v[i][:, n:]], dim=1))
        return self.out_norm(h[:, -1]), KvCache(torch.stack(new_k), torch.stack(new_v))

    def step(self, x: torch.Tensor, position: torch.Tensor, kv: KvCache
             ) -> tuple[torch.Tensor, torch.Tensor, KvCache]:
        """x [B, D] one embedded step at `position` [B] -> (hidden [B, D],
        eos [B], kv')."""
        h = x[:, None, :]
        new_k, new_v = [], []
        for i in range(self.cfg.n_layers):
            h, k_i, v_i = getattr(self, f"blk{i}")(h, position, kv.k[i], kv.v[i])
            new_k.append(k_i)
            new_v.append(v_i)
        hidden = self.out_norm(h)[:, 0]
        eos = self.eos_head(hidden)[:, 0].float()
        return hidden, eos, KvCache(torch.stack(new_k), torch.stack(new_v))


def _time_embed(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of the flow time t in [0, 1]."""
    half = dim // 2
    freqs = torch.exp(-np.log(10000.0) * torch.arange(half, device=t.device, dtype=torch.float32)
                      / half)
    ang = t * 1000.0 * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


class FlowVelocity(nn.Module):
    """Conditional velocity field v(z, t | cond): residual MLP."""

    def __init__(self, cfg: PocketTtsConfig, device=None):
        super().__init__()
        self.cfg = cfg
        Hd = cfg.flow_hidden
        self.time_proj = nn.Linear(Hd, Hd, device=device)
        self.in_proj = nn.Linear(cfg.mimi.latent_dim + cfg.d_model, Hd, device=device)
        for i in range(cfg.flow_blocks):
            self.add_module(f"blk{i}_norm", nn.LayerNorm(Hd, eps=1e-6, device=device))
            self.add_module(f"blk{i}_fc1", nn.Linear(Hd, Hd, device=device))
            self.add_module(f"blk{i}_fc2", nn.Linear(Hd, Hd, device=device))
        self.out_proj = nn.Linear(Hd, cfg.mimi.latent_dim, device=device)

    def forward(self, z, cond, t):
        h = self.in_proj(torch.cat([z, cond], dim=-1)) + self.time_proj(
            _time_embed(t, self.cfg.flow_hidden))
        for i in range(self.cfg.flow_blocks):
            r = getattr(self, f"blk{i}_norm")(h)
            r = getattr(self, f"blk{i}_fc2")(F.silu(getattr(self, f"blk{i}_fc1")(r)))
            h = h + r
        return self.out_proj(h)


class FlowDecoder(nn.Module):
    """flow_decoder_fused: 8 Euler steps. (cond [B, D], noise [B, latent]
    ~ N(0, 1)) -> latent."""

    def __init__(self, cfg: PocketTtsConfig, device=None):
        super().__init__()
        self.velocity = FlowVelocity(cfg, device)

    def forward(self, cond: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        z = noise * np.float32(np.sqrt(TEMPERATURE))
        h = 1.0 / EULER_STEPS
        for k in range(EULER_STEPS):
            t = torch.full((z.shape[0], 1), k * h, dtype=torch.float32, device=z.device)
            z = z + h * self.velocity(z, cond, t)
        return z.float()
