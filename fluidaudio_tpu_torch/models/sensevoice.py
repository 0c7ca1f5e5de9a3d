"""SenseVoice-style non-autoregressive multilingual ASR encoder (SANM + CTC), in PyTorch.

Port of `fluidaudio_tpu/models/sensevoice.py` (reference
`SenseVoice/SenseVoiceManager.swift:4-40`): 560-d LFR features (7-frame
stacking, shift 6, of the 80-mel fbank) -> SANM encoder (self-attention with
an FSMN memory conv) + CTC head. The language/task prompt tokens take the
first 4 frames of the encoder input as learned prefix embeddings.

The numerics follow the JAX module, which is plain XLA there (no Pallas):
the attention is the plain product with the pad mask filled with
`finfo(dtype).min` (not -inf, and not `scaled_dot_product_attention`, which
gives NaN on the fully masked padded query rows that JAX makes uniform), the
softmax runs in f32, and the scores leave the compute dtype when scaled by
`1/sqrt(hd)` (a NumPy scalar in JAX, which promotes to f32). The LayerNorms
use flax's default eps 1e-6, not the FastConformer's 1e-5.

Module and parameter names mirror the flax tree (`block0.qkv.weight` for
`params/block0/qkv/kernel`; the free `embed` table keeps its name), so
`utils.weights.load_npz` maps the JAX package's npz checkpoints directly.
Parameters are stored in the compute dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

LFR_M = 7  # frames stacked
LFR_N = 6  # shift
N_MELS = 80
PROMPT_LEN = 4  # <|lang|><|event|><|emo|><|textnorm|> prefix slots

# FunASR SenseVoiceSmall special-token ids (rows of the 560-d embed table):
# languages {auto:0, zh:3, en:4, yue:7, ja:11, ko:12, nospeech:13},
# event query 1, emotion query 2, textnorm {withitn:14, woitn:15}
EVENT_TOKEN_ID = 1
EMO_TOKEN_ID = 2
TEXTNORM_WITHITN_ID = 14
TEXTNORM_WOITN_ID = 15

#: flax LayerNorm's default epsilon (SANM blocks, the Paraformer and Cohere decoders)
FLAX_LN_EPS = 1e-6


@dataclass(frozen=True)
class SenseVoiceConfig:
    vocab_size: int = 25_055
    d_model: int = 512
    n_layers: int = 50
    tp_blocks: int = 20  # timestamp-predictor SANM stack (FunASR tp_encoders)
    n_heads: int = 4
    ffn_dim: int = 2048
    fsmn_kernel: int = 11
    n_languages: int = 16
    n_special_tokens: int = 16  # embed-table rows (languages + queries)
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def blank_id(self) -> int:
        return 0  # CTC blank at index 0 (FunASR convention)


SENSEVOICE_SMALL = SenseVoiceConfig()
SENSEVOICE_TEST = SenseVoiceConfig(
    vocab_size=64, d_model=64, n_layers=2, tp_blocks=1, n_heads=4, ffn_dim=128,
    dtype="float32"
)


def lfr_stack(mel: torch.Tensor, mel_lengths: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, n_mels, T] -> LFR features [B, T', n_mels*LFR_M], lengths' int32.

    Low-frame-rate stacking: output t covers input frames [t*6, t*6+7) with
    edge replication (FunASR convention).
    """
    B, F_, T = mel.shape
    x = mel.transpose(1, 2)  # [B, T, F]
    t_out = (T + LFR_N - 1) // LFR_N
    idx = (torch.arange(t_out, device=mel.device)[:, None] * LFR_N
           + torch.arange(LFR_M, device=mel.device)[None, :])
    idx = torch.clamp(idx, max=T - 1)  # [T', 7]
    out = x[:, idx, :].reshape(B, t_out, LFR_M * F_)
    out_lengths = torch.clamp(
        torch.div(mel_lengths.to(torch.int64) + LFR_N - 1, LFR_N, rounding_mode="floor"),
        max=t_out).to(torch.int32)
    return out, out_lengths


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax `LayerNorm(dtype=dtype)`: normalise `x` in its own dtype, return `dtype`."""
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype),
                        ln.bias.to(x.dtype), ln.eps).to(dtype)


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor, dtype: torch.dtype
                   ) -> torch.Tensor:
    """JAX's `softmax(where(mask, s, finfo(dtype).min).astype(f32)).astype(dtype)`:
    a fully masked row comes out uniform, never NaN."""
    scores = scores.masked_fill(~mask, torch.finfo(dtype).min)
    return torch.softmax(scores.float(), dim=-1).to(dtype)


def fsmn_memory(conv: nn.Conv1d, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Bias-free depthwise FSMN conv over the masked `x` [B, T, D], padded
    (left, K-1-left) in time, masked again."""
    K = conv.kernel_size[0]
    left = (K - 1) // 2
    m = mask[..., None].to(x.dtype)
    h = F.pad((x * m).transpose(1, 2), (left, K - 1 - left))
    return conv(h).transpose(1, 2) * m


class SanmBlock(nn.Module):
    """FunASR EncoderLayerSANM (pre-norm): fused q/k/v projection, the FSMN
    memory over the VALUE projection (added to the attention output), then a
    ReLU feed-forward. With `in_size != d_model` (the first encoder layer)
    the attention residual is dropped (FunASR `if in_size == size`)."""

    def __init__(self, cfg: SenseVoiceConfig, in_size: int, device=None):
        super().__init__()
        D = cfg.d_model
        self.cfg = cfg
        self.in_size = in_size
        self.norm1 = nn.LayerNorm(in_size, eps=FLAX_LN_EPS, device=device)
        self.qkv = nn.Linear(in_size, 3 * D, device=device)
        self.fsmn = nn.Conv1d(D, D, cfg.fsmn_kernel, groups=D, bias=False, device=device)
        self.out = nn.Linear(D, D, device=device)
        self.norm2 = nn.LayerNorm(D, eps=FLAX_LN_EPS, device=device)
        self.ffn1 = nn.Linear(D, cfg.ffn_dim, device=device)
        self.ffn2 = nn.Linear(cfg.ffn_dim, D, device=device)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        D, H = cfg.d_model, cfg.n_heads
        hd = D // H
        B, T, _ = x.shape

        h = layer_norm(self.norm1, x, dt)
        q, k, v = self.qkv(h).split(D, dim=-1)
        mem = fsmn_memory(self.fsmn, v, pad_mask)

        q = q.reshape(B, T, H, hd).transpose(1, 2)
        k = k.reshape(B, T, H, hd).transpose(1, 2)
        vh = v.reshape(B, T, H, hd).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd)
        att_mask = pad_mask[:, None, None, :] & pad_mask[:, None, :, None]
        probs = masked_softmax(scores, att_mask, dt)
        att = torch.matmul(probs, vh).transpose(1, 2).reshape(B, T, D)
        att = self.out(att) + mem

        x = att if self.in_size != cfg.d_model else x + att
        f = layer_norm(self.norm2, x, dt)
        f = self.ffn2(F.relu(self.ffn1(f)))
        return x + f


def sinusoid_posenc(T: int, dim: int, device=None) -> torch.Tensor:
    """FunASR SinusoidalPositionEncoder: positions 1..T (1-indexed), f32 [T, dim]."""
    pos = torch.arange(1, T + 1, dtype=torch.float32, device=device)
    half = dim // 2
    inv = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / (half - 1)))
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :dim]


class SenseVoiceEncoder(nn.Module):
    """(lfr [B, T, 560], lengths [B], lang_id [B]) -> f32 CTC log-probs [B, P+T, V].

    The 4 prompt embeddings ([lang, event, emo, textnorm] rows of the 560-d
    special-token table) are concatenated with the LFR features, scaled by
    sqrt(d_model) and summed with 1-indexed sinusoidal positions, then
    block0 (in 560) + (n_layers-1) SANM blocks, final_ln, the tp_blocks
    timestamp-predictor stack + tp_norm, and the CTC head."""

    def __init__(self, cfg: SenseVoiceConfig = SENSEVOICE_SMALL, in_size: int = N_MELS * LFR_M,
                 device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.embed = nn.Parameter(torch.zeros(cfg.n_special_tokens, in_size, device=device))
        self.block0 = SanmBlock(cfg, in_size, device)
        for i in range(1, cfg.n_layers):
            self.add_module(f"block{i}", SanmBlock(cfg, D, device))
        self.final_ln = nn.LayerNorm(D, eps=FLAX_LN_EPS, device=device)
        for i in range(cfg.tp_blocks):
            self.add_module(f"tp_block{i}", SanmBlock(cfg, D, device))
        self.tp_norm = nn.LayerNorm(D, eps=FLAX_LN_EPS, device=device)
        self.ctc_head = nn.Linear(D, cfg.vocab_size, device=device)
        self.to(cfg.compute_dtype)

    @torch.no_grad()
    def forward(self, lfr: torch.Tensor, lengths: torch.Tensor, lang_ids: torch.Tensor
                ) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.compute_dtype
        B, T, F_in = lfr.shape
        dev = lfr.device
        lang_ids = lang_ids.long()
        prompt_ids = torch.stack([
            lang_ids,
            torch.full_like(lang_ids, EVENT_TOKEN_ID),
            torch.full_like(lang_ids, EMO_TOKEN_ID),
            torch.full_like(lang_ids, TEXTNORM_WOITN_ID),
        ], dim=1)  # [B, 4]
        pfx = self.embed[prompt_ids].to(dt)
        x = torch.cat([pfx, lfr.to(dt)], dim=1)  # [B, P+T, 560]

        total = PROMPT_LEN + T
        # JAX scales by a NumPy scalar, which promotes to f32
        x = x.float() * math.sqrt(cfg.d_model) + sinusoid_posenc(total, F_in, dev).to(dt)[None]

        pad_mask = torch.arange(total, device=dev)[None, :] < (lengths + PROMPT_LEN)[:, None]
        for i in range(cfg.n_layers):
            x = getattr(self, f"block{i}")(x, pad_mask)
        x = layer_norm(self.final_ln, x, dt)
        for i in range(cfg.tp_blocks):
            x = getattr(self, f"tp_block{i}")(x, pad_mask)
        x = layer_norm(self.tp_norm, x, dt)
        logits = self.ctc_head(x)
        return torch.log_softmax(logits.float(), dim=-1)
