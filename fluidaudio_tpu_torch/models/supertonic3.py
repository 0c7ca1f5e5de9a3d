"""Supertonic-3 multilingual TTS (44.1 kHz, step-fed flow matching), in PyTorch.

Port of `fluidaudio_tpu/models/supertonic3.py` (reference
`Supertonic3/Pipeline/Synthesize/Supertonic3Synthesizer.swift:76-216`):

  duration_predictor(text_ids, text_mask, style_dp) -> duration [B] seconds
  text_encoder(text_ids, text_mask, style_ttl)      -> text_emb [B,256,T]
  vector_estimator(noisy_latent, text_emb, style_ttl, latent_mask, text_mask,
                   current_step, total_step)        -> denoised latent (ONE
                   flow step; fed back `total_step` times)
  vocoder(latent [B,144,L])                         -> wav [B, L*3072]

Shape contract (`Supertonic3Constants.swift:14-59`): latent channels
24 x 6 = 144, a latent frame 512 x 6 = 3072 samples, text T fixed, style_ttl
[B,50,256], style_dp [B,8,16]. The blocks are the JAX package's DiT-style
design over flax's own layers (`FlaxAttention`, LayerNorm eps 1e-6, the
tanh GELU); the vocoder's transposed convs are `F.conv_transpose1d` and its
Snake alphas `alpha<i>` are laid out [1, C, 1] by `utils/weights.py`.
`sample_noisy_latent` is JAX's host draw (numpy `RandomState`), so the
latent is bit-equal to JAX's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from fluidaudio_tpu_torch.models.flax_attention import FlaxAttention
from fluidaudio_tpu_torch.models.kokoro import _Embed

SAMPLE_RATE = 44_100
BASE_CHUNK = 512
CHUNK_COMPRESS = 6
LATENT_DIM = 24
LATENT_CH = LATENT_DIM * CHUNK_COMPRESS  # 144
SAMPLES_PER_LATENT = BASE_CHUNK * CHUNK_COMPRESS  # 3072
TEXT_T = 128  # textTFixed
TTL_STYLE_TOKENS, TTL_STYLE_DIM = 50, 256
DP_STYLE_TOKENS, DP_STYLE_DIM = 8, 16
TEXT_EMB_DIM = 256
DEFAULT_TOTAL_STEPS = 8


@dataclass(frozen=True)
class Supertonic3Config:
    vocab_size: int = 256
    d_model: int = 256
    n_text_layers: int = 4
    n_est_layers: int = 6
    n_heads: int = 4
    est_width: int = 384
    voc_width: int = 192
    voc_rates: tuple[int, ...] = (8, 8, 8)  # 512x from decompressed frames
    text_t: int = TEXT_T
    max_latent: int = 256  # latent bucket (ANE buckets 128/256/512)
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


SUPERTONIC3_BASE = Supertonic3Config()
SUPERTONIC3_TEST = Supertonic3Config(
    vocab_size=64, d_model=32, n_text_layers=1, n_est_layers=1, n_heads=2,
    est_width=32, voc_width=16, voc_rates=(8, 8, 8), text_t=32, max_latent=16,
)


def latent_len_for_duration(duration_s: float) -> int:
    """`Supertonic3LatentSampler.sampleNoisyLatent` latent-length math."""
    wav_len = int(duration_s * SAMPLE_RATE)
    return 0 if wav_len == 0 else (wav_len + SAMPLES_PER_LATENT - 1) // SAMPLES_PER_LATENT


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _ln(d: int, device, affine: bool = True) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=1e-6, elementwise_affine=affine, device=device)


def _embed_ids(table: _Embed, ids: torch.Tensor) -> torch.Tensor:
    """Clip to the table, embed, zero the unknown scalars (-1)."""
    x = F.embedding(torch.clamp(ids.long(), 0, table.embedding.shape[0] - 1), table.embedding)
    return x * (ids >= 0)[..., None].to(x.dtype)


class StyleCross(nn.Module):
    """Cross-attention pooling over a style token bank [B, S, Ds]."""

    def __init__(self, d_model: int, n_heads: int, d_style: int, device=None):
        super().__init__()
        self.style_proj = nn.Linear(d_style, d_model, device=device)
        self.ln = _ln(d_model, device)
        self.attn = FlaxAttention(d_model, n_heads, device)

    def forward(self, x, style):
        return x + self.attn(self.ln(x), self.style_proj(style))


class TransformerBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, device=None):
        super().__init__()
        self.ln1 = _ln(d_model, device)
        self.attn = FlaxAttention(d_model, n_heads, device)
        self.ln2 = _ln(d_model, device)
        self.ff1 = nn.Linear(d_model, 4 * d_model, device=device)
        self.ff2 = nn.Linear(4 * d_model, d_model, device=device)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln1(x), mask=mask)
        return x + self.ff2(_gelu(self.ff1(self.ln2(x))))


class Supertonic3TextEncoder(nn.Module):
    """(text_ids [B,T], text_mask [B,T], style_ttl [B,50,256]) -> text_emb
    [B, TEXT_EMB_DIM, T]."""

    def __init__(self, cfg: Supertonic3Config, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.embed = _Embed(cfg.vocab_size, D, device)
        self.pos = nn.Parameter(torch.zeros(cfg.text_t, D, device=device))
        for i in range(cfg.n_text_layers):
            self.add_module(f"block{i}", TransformerBlock(D, cfg.n_heads, device))
            self.add_module(f"style{i}", StyleCross(D, cfg.n_heads, TTL_STYLE_DIM, device))
        self.out_ln = _ln(D, device)
        self.out_proj = nn.Linear(D, TEXT_EMB_DIM, device=device)

    @torch.no_grad()
    def forward(self, ids, text_mask, style_ttl):
        T = ids.shape[1]
        x = _embed_ids(self.embed, ids) + self.pos[:T][None]
        valid = text_mask > 0
        att = valid[:, None, None, :] & valid[:, None, :, None]
        for i in range(self.cfg.n_text_layers):
            x = getattr(self, f"block{i}")(x, att)
            x = getattr(self, f"style{i}")(x, style_ttl)
        x = self.out_proj(self.out_ln(x)) * valid[..., None]
        return x.transpose(1, 2)  # [B, 256, T]


class Supertonic3DurationPredictor(nn.Module):
    """(text_ids, text_mask, style_dp [B,8,16]) -> duration [B] seconds."""

    def __init__(self, cfg: Supertonic3Config, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.embed = _Embed(cfg.vocab_size, D, device)
        self.style_proj = nn.Linear(DP_STYLE_TOKENS * DP_STYLE_DIM, D, device=device)
        self.conv0 = nn.Conv1d(D, D, 3, padding=1, device=device)
        self.conv1 = nn.Conv1d(D, D, 3, padding=1, device=device)
        self.block = TransformerBlock(D, cfg.n_heads, device)
        self.out = nn.Linear(D, 1, device=device)

    @torch.no_grad()
    def forward(self, ids, text_mask, style_dp):
        B = ids.shape[0]
        x = _embed_ids(self.embed, ids)
        valid = text_mask > 0
        vm = valid[..., None].to(x.dtype)
        x = x + self.style_proj(style_dp.reshape(B, -1))[:, None, :]
        for conv in (self.conv0, self.conv1):
            x = F.silu(conv(x.transpose(1, 2)).transpose(1, 2)) * vm
        att = valid[:, None, None, :] & valid[:, None, :, None]
        x = self.block(x, att)
        n = torch.clamp(valid.sum(dim=1), min=1)
        pooled = (x * vm).sum(dim=1) / n[:, None]
        return F.softplus(self.out(pooled))[:, 0]


class _DiTBlock(nn.Module):
    """adaLN-zero DiT block: self-attention over latent frames + cross-
    attention to text and style tokens, modulated by the step embedding."""

    def __init__(self, width: int, n_heads: int, device=None):
        super().__init__()
        self.mod = nn.Linear(width, 6 * width, device=device)
        self.ln1 = _ln(width, device, affine=False)
        self.attn = FlaxAttention(width, n_heads, device)
        self.ln_c = _ln(width, device)
        self.cross = FlaxAttention(width, n_heads, device)
        self.ln2 = _ln(width, device, affine=False)
        self.ff1 = nn.Linear(width, 4 * width, device=device)
        self.ff2 = nn.Linear(4 * width, width, device=device)

    def forward(self, x, t_emb, ctx, self_mask, ctx_mask):
        s1, b1, g1, s2, b2, g2 = self.mod(F.silu(t_emb))[:, None, :].chunk(6, dim=-1)
        h = self.ln1(x) * (1 + s1) + b1
        x = x + g1 * self.attn(h, mask=self_mask)
        x = x + self.cross(self.ln_c(x), ctx, ctx_mask)
        h = self.ln2(x) * (1 + s2) + b2
        return x + g2 * self.ff2(_gelu(self.ff1(h)))


class Supertonic3VectorEstimator(nn.Module):
    """ONE flow step: (noisy_latent [B,144,L], text_emb [B,256,T], style_ttl
    [B,50,256], latent_mask [B,1,L], text_mask [B,1,T], current_step [B],
    total_step [B]) -> noisy_latent + (1/total) * v(x, t)."""

    def __init__(self, cfg: Supertonic3Config, device=None):
        super().__init__()
        self.cfg = cfg
        w = cfg.est_width
        self.in_proj = nn.Linear(LATENT_CH, w, device=device)
        self.pos = nn.Parameter(torch.zeros(cfg.max_latent, w, device=device))
        self.t1 = nn.Linear(w, w, device=device)
        self.t2 = nn.Linear(w, w, device=device)
        self.ctx_proj = nn.Linear(TEXT_EMB_DIM, w, device=device)
        self.sty_proj = nn.Linear(TTL_STYLE_DIM, w, device=device)
        for i in range(cfg.n_est_layers):
            self.add_module(f"block{i}", _DiTBlock(w, cfg.n_heads, device))
        self.out_ln = _ln(w, device)
        self.out_proj = nn.Linear(w, LATENT_CH, device=device)

    @torch.no_grad()
    def forward(self, noisy_latent, text_emb, style_ttl, latent_mask, text_mask,
                current_step, total_step):
        w = self.cfg.est_width
        B, _, L = noisy_latent.shape
        x = self.in_proj(noisy_latent.transpose(1, 2)) + self.pos[:L][None]
        t = (current_step / torch.clamp(total_step, min=1.0))[:, None]
        half = w // 2
        freqs = torch.exp(-math.log(10000.0)
                          * torch.arange(half, device=x.device, dtype=torch.float32) / half)
        te = torch.cat([torch.sin(t * freqs * 1000.0), torch.cos(t * freqs * 1000.0)], dim=-1)
        t_emb = self.t2(F.silu(self.t1(te)))
        ctx = torch.cat([self.ctx_proj(text_emb.transpose(1, 2)), self.sty_proj(style_ttl)], dim=1)
        tmask = text_mask[:, 0, :] > 0
        ctx_valid = torch.cat([tmask, torch.ones((B, style_ttl.shape[1]), dtype=torch.bool,
                                                 device=x.device)], dim=1)
        lvalid = latent_mask[:, 0, :] > 0
        self_mask = lvalid[:, None, None, :] & lvalid[:, None, :, None]
        ctx_mask = lvalid[:, None, :, None] & ctx_valid[:, None, None, :]
        for i in range(self.cfg.n_est_layers):
            x = getattr(self, f"block{i}")(x, t_emb, ctx, self_mask, ctx_mask)
        v = self.out_proj(self.out_ln(x)).transpose(1, 2) * latent_mask
        dt = (1.0 / torch.clamp(total_step, min=1.0))[:, None, None]
        return noisy_latent + dt * v


class _SnakeResBlock(nn.Module):
    def __init__(self, channels: int, kernel: int = 3, dilations=(1, 3), device=None):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.register_parameter(f"alpha{i}",
                                    nn.Parameter(torch.ones(1, channels, 1, device=device)))
            self.add_module(f"conv{i}", nn.Conv1d(channels, channels, kernel, dilation=d,
                                                  padding=(kernel * d - d) // 2, device=device))

    def forward(self, x):
        for i in range(self.n):
            a = getattr(self, f"alpha{i}")
            x = x + getattr(self, f"conv{i}")(x + (1.0 / a) * torch.sin(a * x) ** 2)
        return x


class Supertonic3Vocoder(nn.Module):
    """latent [B,144,L] -> wav [B, L*3072]: un-pack the 6x chunk packing
    ([B, 24, 6L]), then a transposed-conv upsampler (8*8*8 = 512x) with Snake
    resblocks, on [B, C, T]."""

    def __init__(self, cfg: Supertonic3Config, device=None):
        super().__init__()
        self.cfg = cfg
        ch = cfg.voc_width
        self.pre = nn.Conv1d(LATENT_DIM, ch, 7, padding=3, device=device)
        for i, r in enumerate(cfg.voc_rates):
            c_out = max(ch // 2, 8)
            # F.conv_transpose1d layout [in, out, k] (utils/weights.py)
            self.register_parameter(f"up_kernel_{i}",
                                    nn.Parameter(torch.zeros(ch, c_out, 2 * r, device=device)))
            self.register_parameter(f"up_bias_{i}", nn.Parameter(torch.zeros(c_out, device=device)))
            self.add_module(f"res{i}", _SnakeResBlock(c_out, device=device))
            ch = c_out
        self.post = nn.Conv1d(ch, 1, 7, padding=3, device=device)

    @torch.no_grad()
    def forward(self, latent):
        B, C, L = latent.shape
        x = latent.transpose(1, 2).reshape(B, L * CHUNK_COMPRESS, LATENT_DIM).transpose(1, 2)
        x = self.pre(x)
        for i, r in enumerate(self.cfg.voc_rates):
            k = 2 * r
            x = F.conv_transpose1d(F.leaky_relu(x, 0.1), getattr(self, f"up_kernel_{i}"),
                                   getattr(self, f"up_bias_{i}"), stride=r, padding=(k - r) // 2)
            x = getattr(self, f"res{i}")(x)
        wav = torch.tanh(self.post(x)[:, 0])
        want = L * SAMPLES_PER_LATENT
        if wav.shape[1] > want:
            wav = wav[:, :want]
        elif wav.shape[1] < want:
            wav = F.pad(wav, (0, want - wav.shape[1]))
        return wav


def sample_noisy_latent(
    durations_s: np.ndarray, max_latent: int, rng: np.random.RandomState
) -> tuple[np.ndarray, np.ndarray, int]:
    """Host-side parity with `Supertonic3LatentSampler.sampleNoisyLatent`:
    Gaussian latent [B,144,Lb] zeroed past each row's latent length, float
    mask [B,1,Lb], true max length. `Lb` is the static bucket."""
    durations_s = np.asarray(durations_s, np.float32).reshape(-1)
    B = durations_s.shape[0]
    lens = np.array([latent_len_for_duration(float(d)) for d in durations_s])
    true_len = int(lens.max()) if len(lens) else 0
    Lb = max_latent
    z = rng.randn(B, LATENT_CH, Lb).astype(np.float32)
    mask = (np.arange(Lb)[None, :] < lens[:, None]).astype(np.float32)
    z *= mask[:, None, :]
    return z, mask[:, None, :], min(true_len, Lb)


@torch.no_grad()
def random_init_supertonic3_(module: nn.Module, generator: torch.Generator) -> None:
    """`random_init_kokoro_` (LeCun-normal transposed-conv kernels, unit Snake
    alphas), then flax's zero inits of the DiT: each block's `mod` and the
    estimator's `out_proj` kernels."""
    from fluidaudio_tpu_torch.models.kokoro import random_init_kokoro_

    random_init_kokoro_(module, generator)
    for name, p in module.named_parameters():
        if name.endswith(".mod.weight") or (isinstance(module, Supertonic3VectorEstimator)
                                            and name == "out_proj.weight"):
            p.zero_()
