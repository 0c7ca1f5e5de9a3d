"""Paraformer-style non-autoregressive zh ASR (SANM encoder + CIF + parallel
decoder), in PyTorch.

Port of `fluidaudio_tpu/models/paraformer.py` (reference
`Paraformer/ParaformerManager.swift:10`, `ParaformerCif.swift`): SANM
encoder -> CIF alpha predictor -> integrate-and-fire -> parallel SANM
decoder (FunASR DecoderLayerSANM: FSMN self-memory + fused-kv cross
attention + decoder FFN with hidden LayerNorm and bias-free w_2), then a
final FFN-only layer with no residual. CIF is the closed-form overlap matrix
of the JAX module, so the whole model runs on the device with no host step.

Numerics as in `models/sensevoice.py` (plain product attention with the
`finfo(dtype).min` fill and an f32 softmax, flax's LayerNorm eps 1e-6). The
token count is the floor of the last entry of the SAME cumulative sum that
builds the CIF weights, as in JAX. At inference a virtual tail frame (alpha
0.45, zero hidden) flushes the integration residual.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from fluidaudio_tpu_torch.models.sensevoice import (
    FLAX_LN_EPS,
    LFR_M,
    N_MELS,
    SanmBlock,
    SenseVoiceConfig,
    fsmn_memory,
    layer_norm,
    masked_softmax,
    sinusoid_posenc,
)


@dataclass(frozen=True)
class ParaformerConfig:
    vocab_size: int = 8404
    d_model: int = 512
    n_encoder_layers: int = 50
    n_decoder_layers: int = 16
    n_heads: int = 4
    ffn_dim: int = 2048
    fsmn_kernel: int = 11
    max_tokens: int = 128  # static CIF output grid
    cif_threshold: float = 1.0
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def sanm(self) -> SenseVoiceConfig:
        return SenseVoiceConfig(
            vocab_size=self.vocab_size, d_model=self.d_model,
            n_layers=self.n_encoder_layers, n_heads=self.n_heads,
            ffn_dim=self.ffn_dim, fsmn_kernel=self.fsmn_kernel, dtype=self.dtype,
        )


PARAFORMER_LARGE = ParaformerConfig()
PARAFORMER_TEST = ParaformerConfig(
    vocab_size=64, d_model=64, n_encoder_layers=2, n_decoder_layers=2,
    ffn_dim=128, max_tokens=32, dtype="float32",
)

#: FunASR cif_predictor tail_threshold: the virtual tail frame's alpha
CIF_TAIL_ALPHA = 0.45


def cif_integrate(h: torch.Tensor, alphas: torch.Tensor, max_tokens: int,
                  threshold: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Continuous integrate-and-fire as a closed-form overlap matrix.

    h [B, T, D], alphas [B, T] (>=0) -> (acoustic embeddings [B, U, D],
    token_counts [B] int32). Token u aggregates frames weighted by the overlap
    of the frame's alpha-interval [csum_{t-1}, csum_t) with [u*thr, (u+1)*thr).
    """
    B = h.shape[0]
    csum = torch.cumsum(alphas, dim=1)  # [B, T]
    lo = torch.cat([torch.zeros((B, 1), dtype=alphas.dtype, device=alphas.device),
                    csum[:, :-1]], dim=1)
    u_edges = torch.arange(max_tokens, dtype=alphas.dtype, device=alphas.device) * threshold
    upper = torch.minimum(csum[:, :, None], (u_edges + threshold)[None, None, :])
    lower = torch.maximum(lo[:, :, None], u_edges[None, None, :])
    w = torch.clamp(upper - lower, min=0.0) / threshold  # [B, T, U]
    emb = torch.einsum("btu,btd->bud", w.to(h.dtype), h)
    counts = torch.clamp(torch.floor(csum[:, -1] / threshold), max=max_tokens).to(torch.int32)
    return emb, counts


class CifPredictor(nn.Module):
    """Encoder states -> per-frame alphas (FunASR predictor: cif_conv1d ->
    relu -> cif_output linear -> sigmoid), f32."""

    def __init__(self, cfg: ParaformerConfig, device=None):
        super().__init__()
        self.conv = nn.Conv1d(cfg.d_model, cfg.d_model, 3, padding=1, device=device)
        self.alpha_head = nn.Linear(cfg.d_model, 1, device=device)

    def forward(self, h: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv(h.transpose(1, 2)).transpose(1, 2))
        a = torch.sigmoid(self.alpha_head(x)[..., 0].float())
        return a * pad_mask.float()


class DecoderFfn(nn.Module):
    """FunASR PositionwiseFeedForwardDecoderSANM: w_2(norm(relu(w_1(x)))),
    w_2 bias-free with a LayerNorm over the hidden dim."""

    def __init__(self, cfg: ParaformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.ffn1 = nn.Linear(cfg.d_model, cfg.ffn_dim, device=device)
        self.ffn_norm = nn.LayerNorm(cfg.ffn_dim, eps=FLAX_LN_EPS, device=device)
        self.ffn2 = nn.Linear(cfg.ffn_dim, cfg.d_model, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = layer_norm(self.ffn_norm, F.relu(self.ffn1(x)), self.cfg.compute_dtype)
        return self.ffn2(f)


class DecoderBlock(nn.Module):
    """FunASR DecoderLayerSANM: the FFN runs first with no residual of its
    own, the layer residual joins after the FSMN memory, then fused-kv cross
    attention: t = ffn(norm1(x)); x = x + fsmn(norm2(t)); x = x + cross(norm3(x))."""

    def __init__(self, cfg: ParaformerConfig, device=None):
        super().__init__()
        D = cfg.d_model
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(D, eps=FLAX_LN_EPS, device=device)
        self.ffn = DecoderFfn(cfg, device)
        self.norm2 = nn.LayerNorm(D, eps=FLAX_LN_EPS, device=device)
        self.fsmn = nn.Conv1d(D, D, cfg.fsmn_kernel, groups=D, bias=False, device=device)
        self.norm3 = nn.LayerNorm(D, eps=FLAX_LN_EPS, device=device)
        self.q = nn.Linear(D, D, device=device)
        self.kv = nn.Linear(D, 2 * D, device=device)
        self.out = nn.Linear(D, D, device=device)

    def forward(self, x, enc, tok_mask, cross_mask):
        cfg = self.cfg
        dt = cfg.compute_dtype
        D, H = cfg.d_model, cfg.n_heads
        hd = D // H
        B, U, _ = x.shape
        Tenc = enc.shape[1]

        residual = x
        t = self.ffn(layer_norm(self.norm1, x, dt))
        h = layer_norm(self.norm2, t, dt)
        x = residual + fsmn_memory(self.fsmn, h, tok_mask)

        h = layer_norm(self.norm3, x, dt)
        q = self.q(h).reshape(B, U, H, hd).transpose(1, 2)
        k, v = self.kv(enc).split(D, dim=-1)
        k = k.reshape(B, Tenc, H, hd).transpose(1, 2)
        v = v.reshape(B, Tenc, H, hd).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd)
        probs = masked_softmax(scores, cross_mask, dt)
        att = torch.matmul(probs, v).transpose(1, 2).reshape(B, U, D)
        return x + self.out(att)


class Paraformer(nn.Module):
    """(lfr [B, T, 560], lengths [B]) -> (f32 logits [B, U, V], token_counts [B]).

    With `target_lengths` (training) the alphas are rescaled so the fire
    count equals the label length, and the raw alpha sum is returned too."""

    def __init__(self, cfg: ParaformerConfig = PARAFORMER_LARGE, in_size: int = N_MELS * LFR_M,
                 device=None):
        super().__init__()
        self.cfg = cfg
        sanm = cfg.sanm()
        self.enc0 = SanmBlock(sanm, in_size, device)
        for i in range(1, cfg.n_encoder_layers):
            self.add_module(f"enc{i}", SanmBlock(sanm, sanm.d_model, device))
        self.enc_ln = nn.LayerNorm(cfg.d_model, eps=FLAX_LN_EPS, device=device)
        self.cif = CifPredictor(cfg, device)
        for i in range(cfg.n_decoder_layers):
            self.add_module(f"dec{i}", DecoderBlock(cfg, device))
        self.dec3_norm1 = nn.LayerNorm(cfg.d_model, eps=FLAX_LN_EPS, device=device)
        self.dec3_ffn = DecoderFfn(cfg, device)
        self.dec_ln = nn.LayerNorm(cfg.d_model, eps=FLAX_LN_EPS, device=device)
        self.head = nn.Linear(cfg.d_model, cfg.vocab_size, device=device)
        self.to(cfg.compute_dtype)

    def encode(self, lfr: torch.Tensor, lengths: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (encoder states [B, T, D] in the compute dtype, pad mask [B, T])."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        B, T, F_in = lfr.shape
        # sqrt(d_model) scale (a NumPy scalar in JAX: promotes to f32) +
        # 1-indexed sinusoid positions
        x = lfr.to(dt).float() * math.sqrt(cfg.d_model) \
            + sinusoid_posenc(T, F_in, lfr.device).to(dt)[None]
        pad_mask = torch.arange(T, device=lfr.device)[None, :] < lengths[:, None]
        for i in range(cfg.n_encoder_layers):
            x = getattr(self, f"enc{i}")(x, pad_mask)
        return layer_norm(self.enc_ln, x, dt), pad_mask

    @torch.no_grad()
    def forward(self, lfr: torch.Tensor, lengths: torch.Tensor,
                target_lengths: torch.Tensor | None = None):
        cfg = self.cfg
        dt = cfg.compute_dtype
        enc, pad_mask = self.encode(lfr, lengths)

        alphas = self.cif(enc, pad_mask)
        alpha_sum = alphas.sum(dim=1)
        if target_lengths is not None:
            scale = target_lengths.to(alphas.dtype) / torch.clamp(alpha_sum, min=1e-6)
            emb, counts = cif_integrate(enc, alphas * scale[:, None], cfg.max_tokens,
                                        cfg.cif_threshold)
        else:
            B = alphas.shape[0]
            tail = torch.full((B, 1), CIF_TAIL_ALPHA, dtype=alphas.dtype, device=alphas.device)
            emb, counts = cif_integrate(
                torch.cat([enc, torch.zeros_like(enc[:, :1])], dim=1),
                torch.cat([alphas, tail], dim=1), cfg.max_tokens, cfg.cif_threshold)

        tok_mask = torch.arange(cfg.max_tokens, device=enc.device)[None, :] < counts[:, None]
        cross_mask = tok_mask[:, None, :, None] & pad_mask[:, None, None, :]
        y = emb.to(dt)
        for i in range(cfg.n_decoder_layers):
            y = getattr(self, f"dec{i}")(y, enc, tok_mask, cross_mask)
        # decoders3: the final FFN-only layer, returned with NO residual
        y = self.dec3_ffn(layer_norm(self.dec3_norm1, y, dt))
        y = layer_norm(self.dec_ln, y, dt)
        logits = self.head(y).float()
        if target_lengths is not None:
            return logits, counts, alpha_sum
        return logits, counts
