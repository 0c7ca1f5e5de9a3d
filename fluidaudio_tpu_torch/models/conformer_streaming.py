"""Cache-aware streaming FastConformer encoder (EOU / Nemotron family), in PyTorch.

Port of `fluidaudio_tpu/models/conformer_streaming.py`. One call is one
chunk step with carried caches, all of them tensors on the encoder's device:
the mel pre-cache [B, n_mels, 16], the per-layer attention left context
(`channel` [L, B, C, D]: the LayerNorm'd block inputs, not K/V, so K and V
are projected again over C+T rows each chunk, as in JAX) and the causal-conv
tail (`time` [L, B, k-1, D]).

Architecture: causal subsampling (time padded (2, 0), frequency (1, 1)),
causal depthwise convs fed by the carried tail, and attention over
[cache | chunk] with a causal mask, a cache-length mask and Transformer-XL
relative positions whose offsets ascend from -(C+T-1) to T-1. The attention
is plain `torch.matmul` here, as it is plain XLA in the JAX package (no
Pallas kernel computes it).

Module and parameter names mirror the flax tree (`stem`, `dw0`, `pw0`, `dw1`,
`pw1`, `proj` and `block{i}` at the top, no `subsampling.` prefix), so
`utils.weights.load_npz` maps the JAX package's npz checkpoints 1:1.
Parameters are stored in the compute dtype; the caches take it too, except
`pre_cache` (f32) and `channel_len` (int32); the encoder output is f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from fluidaudio_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class StreamingConformerConfig:
    n_mels: int = 128
    d_model: int = 512
    n_layers: int = 17
    n_heads: int = 8
    ffn_expansion: int = 4
    conv_kernel: int = 9
    att_context_left: int = 70  # cached frames per layer
    pre_cache_mel: int = 16  # mel frames of subsampling left context
    subsampling_channels: int = 256
    dtype: str = "float32"
    # NeMo ConformerEncoder `xscaling` (sqrt(d_model) on subsampled features)
    xscale: bool = True

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def conv_cache(self) -> int:
        return self.conv_kernel - 1


EOU_120M = StreamingConformerConfig()
NEMOTRON_EN = StreamingConformerConfig(d_model=1024, n_layers=24)


class StreamingCaches(NamedTuple):
    pre_cache: torch.Tensor  # [B, n_mels, pre_cache_mel] f32
    channel: torch.Tensor  # [L, B, att_context_left, D] attention K/V inputs
    time: torch.Tensor  # [L, B, conv_kernel-1, D] conv tails
    channel_len: torch.Tensor  # [B] int32 valid frames in the channel cache


def init_caches(cfg: StreamingConformerConfig, batch: int,
                device: torch.device | str | None = None) -> StreamingCaches:
    """Empty caches for `batch` streams. `device=None` is the GPU
    (RuntimeError without one); pass "cpu" to run on the CPU."""
    device = resolve_device(device)
    dt = cfg.compute_dtype
    return StreamingCaches(
        pre_cache=torch.zeros((batch, cfg.n_mels, cfg.pre_cache_mel), dtype=torch.float32,
                              device=device),
        channel=torch.zeros((cfg.n_layers, batch, cfg.att_context_left, cfg.d_model),
                            dtype=dt, device=device),
        time=torch.zeros((cfg.n_layers, batch, cfg.conv_cache, cfg.d_model), dtype=dt,
                         device=device),
        channel_len=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def sinusoid_offsets(n: int, max_neg: int, d_model: int, device=None) -> torch.Tensor:
    """[n, d_model] f32 sinusoids for the ASCENDING offsets -max_neg ..
    n-1-max_neg (offset o at row o + max_neg), sin at even and cos at odd
    feature indices (NeMo `create_pe`). The offline encoder's `rel_sinusoid`
    runs the other way and is not this function."""
    off = torch.arange(n, dtype=torch.float32, device=device) - max_neg
    inv = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d_model))
    ang = off[:, None] * inv[None, :]
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(n, d_model)


def _layer_norm(d: int, device) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=1e-5, device=device)


class _ChunkContext(NamedTuple):
    """What every layer's attention shares within one chunk step."""

    pos: torch.Tensor  # [C+2T-1, D] sinusoids of offsets -(C+T-1) .. T-1
    off_idx: torch.Tensor  # [T, C+T] int64: key s of query t -> its offset row
    mask: torch.Tensor  # [B, 1, T, C+T] causal within the chunk, valid cache rows


def _chunk_context(cfg: StreamingConformerConfig, T: int, cache_len: torch.Tensor,
                   dtype: torch.dtype) -> _ChunkContext:
    C = cfg.att_context_left
    S = C + T
    dev = cache_len.device
    t_idx = torch.arange(T, device=dev)[:, None]
    s_idx = torch.arange(S, device=dev)[None, :]
    # relative offset of key s to query C + t is s - C - t in [-(S-1), T-1]
    off_idx = s_idx - C - t_idx + (S - 1)
    causal = s_idx <= C + t_idx  # [T, S]
    cache_valid = s_idx >= (C - cache_len.long())[:, None, None]  # [B, 1, S]
    return _ChunkContext(
        pos=sinusoid_offsets(C + 2 * T - 1, S - 1, cfg.d_model, dev).to(dtype),
        off_idx=off_idx,
        mask=(causal[None] & cache_valid)[:, None],
    )


class _StreamRelPosMHSA(nn.Module):
    """Q over the chunk, K/V over [cache | chunk], causal + bounded left."""

    def __init__(self, cfg: StreamingConformerConfig, device=None):
        super().__init__()
        d, H, Dh = cfg.d_model, cfg.n_heads, cfg.head_dim
        self.cfg = cfg
        self.ln = _layer_norm(d, device)
        self.q = nn.Linear(d, d, device=device)
        self.k = nn.Linear(d, d, device=device)
        self.v = nn.Linear(d, d, device=device)
        self.pos = nn.Linear(d, d, bias=False, device=device)
        self.pos_bias_u = nn.Parameter(torch.zeros(H, Dh, device=device))
        self.pos_bias_v = nn.Parameter(torch.zeros(H, Dh, device=device))
        self.out = nn.Linear(d, d, device=device)

    def forward(self, x: torch.Tensor, cache: torch.Tensor, ctx: _ChunkContext
                ) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        B, T, D = x.shape
        C = cfg.att_context_left
        H, Dh = cfg.n_heads, cfg.head_dim
        S = C + T

        xs = self.ln(x)
        kv_in = torch.cat([cache, xs], dim=1)  # [B, C+T, D]
        q = self.q(xs).reshape(B, T, H, Dh)
        k = self.k(kv_in).reshape(B, S, H, Dh)
        v = self.v(kv_in).reshape(B, S, H, Dh)
        p = self.pos(ctx.pos).reshape(-1, H, Dh)  # [C+2T-1, H, Dh]

        ac = torch.matmul((q + self.pos_bias_u).transpose(1, 2),
                          k.permute(0, 2, 3, 1))  # [B, H, T, S]
        bd_all = torch.matmul((q + self.pos_bias_v).transpose(1, 2),
                              p.permute(1, 2, 0))  # [B, H, T, C+2T-1]
        bd = torch.gather(bd_all, 3, ctx.off_idx.expand(B, H, T, S))
        scores = (ac + bd) / math.sqrt(Dh)
        scores = torch.where(ctx.mask, scores, torch.finfo(x.dtype).min)
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        out = torch.matmul(probs, v.transpose(1, 2))  # [B, H, T, Dh]
        out = self.out(out.transpose(1, 2).reshape(B, T, D))
        # new cache: the last C pre-attention LayerNorm'd inputs
        return out, kv_in[:, -C:]


class _StreamConv(nn.Module):
    """Causal conformer conv module with a carried left tail."""

    def __init__(self, cfg: StreamingConformerConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.ln = _layer_norm(d, device)
        self.pointwise1 = nn.Linear(d, 2 * d, device=device)
        # NeMo depthwise_conv has no bias; VALID over [tail | chunk]
        self.depthwise = nn.Conv1d(d, d, cfg.conv_kernel, groups=d, bias=False, device=device)
        self.bn_scale = nn.Parameter(torch.ones(d, device=device))
        self.bn_bias = nn.Parameter(torch.zeros(d, device=device))
        self.pointwise2 = nn.Linear(d, d, device=device)

    def forward(self, x: torch.Tensor, tail: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        xs = self.pointwise1(self.ln(x))
        a, b = xs.chunk(2, dim=-1)
        xs = a * torch.sigmoid(b)
        full = torch.cat([tail, xs], dim=1)  # [B, k-1+T, D]
        y = self.depthwise(full.transpose(1, 2)).transpose(1, 2)
        y = F.silu(y * self.bn_scale + self.bn_bias)
        return self.pointwise2(y), full[:, -self.cfg.conv_cache:]


class _StreamBlock(nn.Module):
    def __init__(self, cfg: StreamingConformerConfig, device=None):
        super().__init__()
        d, d_ff = cfg.d_model, cfg.d_model * cfg.ffn_expansion
        # flat names mirror the flax tree (ffn1_ln, ffn1_fc1, ...)
        for name in ("ffn1", "ffn2"):
            setattr(self, f"{name}_ln", _layer_norm(d, device))
            setattr(self, f"{name}_fc1", nn.Linear(d, d_ff, device=device))
            setattr(self, f"{name}_fc2", nn.Linear(d_ff, d, device=device))
        self.mhsa = _StreamRelPosMHSA(cfg, device)
        self.conv = _StreamConv(cfg, device)
        self.final_ln = _layer_norm(d, device)

    def _ffn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        h = F.silu(getattr(self, f"{name}_fc1")(getattr(self, f"{name}_ln")(x)))
        return getattr(self, f"{name}_fc2")(h)

    def forward(self, x, ch_cache, time_cache, ctx: _ChunkContext):
        x = x + 0.5 * self._ffn(x, "ffn1")
        att, new_ch = self.mhsa(x, ch_cache, ctx)
        x = x + att
        conv, new_time = self.conv(x, time_cache)
        x = x + conv
        x = x + 0.5 * self._ffn(x, "ffn2")
        return self.final_ln(x), new_ch, new_time


class StreamingConformerEncoder(nn.Module):
    """One chunk step: (mel_chunk [B, n_mels, T_mel], caches) ->
    (f32 enc [B, T_mel/8, D], caches'). T_mel must be a multiple of 8; the
    mel pre-cache supplies the subsampling's left context."""

    def __init__(self, cfg: StreamingConformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        c = cfg.subsampling_channels
        self.stem = nn.Conv2d(1, c, 3, stride=2, device=device)
        self.dw0 = nn.Conv2d(c, c, 3, stride=2, groups=c, device=device)
        self.pw0 = nn.Conv2d(c, c, 1, device=device)
        self.dw1 = nn.Conv2d(c, c, 3, stride=2, groups=c, device=device)
        self.pw1 = nn.Conv2d(c, c, 1, device=device)
        f8 = cfg.n_mels
        for _ in range(3):
            f8 = (f8 - 1) // 2 + 1
        self.proj = nn.Linear(c * f8, cfg.d_model, device=device)
        for i in range(cfg.n_layers):
            self.add_module(f"block{i}", _StreamBlock(cfg, device))
        self.to(cfg.compute_dtype)

    @staticmethod
    def _causal(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        # flax padding ((2, 0), (1, 1)) on (time, freq): no look-ahead
        return conv(F.pad(x, (1, 1, 2, 0)))

    @torch.no_grad()
    def forward(self, mel_chunk: torch.Tensor, caches: StreamingCaches
                ) -> tuple[torch.Tensor, StreamingCaches]:
        cfg = self.cfg
        pc = cfg.pre_cache_mel
        full_mel = torch.cat([caches.pre_cache, mel_chunk.float()], dim=2)
        new_pre = full_mel[:, :, -pc:]

        x = full_mel.transpose(1, 2)[:, None].to(cfg.compute_dtype)  # [B, 1, T, F]
        x = F.relu(self._causal(self.stem, x))
        x = F.relu(self.pw0(self._causal(self.dw0, x)))
        x = F.relu(self.pw1(self._causal(self.dw1, x)))
        B, C8, T8, F8 = x.shape
        # flatten CHANNEL-major (C, F) like NeMo ConvSubsampling
        x = self.proj(x.permute(0, 2, 1, 3).reshape(B, T8, C8 * F8))
        if cfg.xscale:
            x = x * math.sqrt(cfg.d_model)
        # drop the frames contributed by the pre-cache context
        x = x[:, pc // 8:]

        ctx = _chunk_context(cfg, x.shape[1], caches.channel_len, x.dtype)
        new_ch, new_time = [], []
        for i in range(cfg.n_layers):
            x, ch_i, t_i = getattr(self, f"block{i}")(
                x, caches.channel[i], caches.time[i], ctx)
            new_ch.append(ch_i)
            new_time.append(t_i)

        new_len = torch.clamp(caches.channel_len + x.shape[1], max=cfg.att_context_left)
        new_caches = StreamingCaches(
            pre_cache=new_pre,
            channel=torch.stack(new_ch),
            time=torch.stack(new_time),
            channel_len=new_len.to(torch.int32),
        )
        return x.float(), new_caches
