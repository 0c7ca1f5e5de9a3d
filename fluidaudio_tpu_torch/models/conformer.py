"""FastConformer encoder (NeMo-style, full or limited context) as torch modules.

Port of `fluidaudio_tpu/models/conformer.py`'s offline encoder:
  - 8x depthwise-separable striding subsampling (3 conv stages, stride 2 each)
  - N conformer blocks: 0.5*FFN -> rel-pos MHSA -> conv module -> 0.5*FFN -> LN
  - Transformer-XL relative positional multi-head attention through
    `ops.attention.relpos_attention` (the CUDA kernel on a GPU) or
    `relpos_attention_plain` on the tensors' own device, chosen by
    `ConformerEncoder.attention_route` before any launch, as the JAX encoder
    branches between its Pallas and einsum paths; a limited attention
    context (`att_context_left/right`, e.g. `EOU_120M`) takes the plain
    version over its band, as JAX takes its einsum path under the mask
  - conv module: LN -> pointwise(2d, GLU) -> depthwise(k) -> BN -> SiLU -> pointwise

The forward is differentiable: serving callers run it under `torch.no_grad`
(the managers and pipelines) or on frozen parameters (`AsrModels.load`), and
`parallel/train.py` trains it. Batch norm is JAX's folded inference form
(`bn_scale`, `bn_bias`) and there is no dropout, so `module.train()` changes
nothing: a train step differentiates the function that serving runs.

Module and parameter names mirror the flax tree (`block{i}.mhsa.q.weight` for
`params/block{i}/mhsa/q/kernel`), so `utils.weights.load_npz` maps the JAX
package's npz checkpoints directly. Parameters are stored in the compute
dtype (`ConformerConfig.dtype`); the encoder output is f32.

`ConformerConfig.quantization="int8"` swaps the layers that JAX builds with
`_dense` (FFN fc1/fc2, the q/k/v/pos/out projections, the conv module's
pointwise convs and the subsampling projection) for `ops.quant.Int8Linear`,
whose f32 scales and biases survive the cast to the compute dtype.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn
from torch.nn import functional as F

from fluidaudio_tpu_torch.ops.attention import (
    kernel_takes_head_dim,
    relpos_attention,
    relpos_attention_plain,
)
from fluidaudio_tpu_torch.ops.quant import Int8Linear

AttentionFn = Callable[..., torch.Tensor]


@dataclass(frozen=True)
class ConformerConfig:
    n_mels: int = 128
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 8
    ffn_expansion: int = 4
    conv_kernel: int = 9
    subsampling_factor: int = 8  # the three stride-2 convolutions (as in JAX, not read)
    subsampling_channels: int = 256
    dropout: float = 0.0  # inference default (as in JAX, not read)
    # limited attention context in frames, -1 = full: the offline encoder
    # masks keys outside [t - left, t + right] (the plain attention, as JAX
    # takes its einsum path there); the cache-aware streaming encoder is
    # models/conformer_streaming.py
    att_context_left: int = -1
    att_context_right: int = -1
    dtype: str = "bfloat16"  # compute dtype
    # JAX's choice of attention path: "auto" (the rel-pos attention kernel
    # where it takes the head width; see `ConformerEncoder.attention_route`)
    # or "xla" (JAX's einsum path: `relpos_attention_plain` at every Dh)
    attention_backend: str = "auto"
    # "none" | "int8": dynamic w8a8 on the large matmuls through
    # ops/quant.Int8Linear (weights quantised once, at load)
    quantization: str = "none"
    # NeMo ConformerEncoder `xscaling`: multiply subsampled features by
    # sqrt(d_model) before the blocks
    xscale: bool = True

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def out_length(self, mel_frames: int) -> int:
        """Encoder frame count after 8x subsampling (3 stride-2 convs, k=3, p=1)."""
        t = mel_frames
        for _ in range(3):
            t = (t + 2 - 3) // 2 + 1
        return t


# Presets (sizes from SURVEY.md §2.4 / NeMo checkpoints), JAX's values
PARAKEET_V3 = ConformerConfig()  # 0.6B: 24 x 1024, 8 heads
PARAKEET_V2 = ConformerConfig()
PARAKEET_110M = ConformerConfig(d_model=512, n_layers=17)
EOU_120M = ConformerConfig(
    d_model=512, n_layers=17, att_context_left=70, att_context_right=0
)


def _layer_norm(d: int, device) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=1e-5, device=device)


def _linear(cfg: ConformerConfig, d_in: int, d_out: int, bias: bool = True,
            device=None) -> nn.Module:
    """nn.Linear or its int8 drop-in, per cfg.quantization (JAX `_dense`)."""
    if cfg.quantization == "int8":
        return Int8Linear(d_in, d_out, bias=bias, out_dtype=cfg.compute_dtype, device=device)
    if cfg.quantization != "none":
        raise ValueError(f"quantization must be 'none' or 'int8', got {cfg.quantization!r}")
    return nn.Linear(d_in, d_out, bias=bias, device=device)


class GLUConv(nn.Module):
    """Conformer convolution module (inference BN folded as scale/bias)."""

    def __init__(self, cfg: ConformerConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.ln = _layer_norm(d, device)
        self.pointwise1 = _linear(cfg, d, 2 * d, device=device)
        # NeMo depthwise_conv has no bias; SAME padding
        self.depthwise = nn.Conv1d(d, d, cfg.conv_kernel, padding=cfg.conv_kernel // 2,
                                   groups=d, bias=False, device=device)
        self.bn_scale = nn.Parameter(torch.ones(d, device=device))
        self.bn_bias = nn.Parameter(torch.zeros(d, device=device))
        self.pointwise2 = _linear(cfg, d, d, device=device)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        x = self.pointwise1(self.ln(x))
        a, b = x.chunk(2, dim=-1)
        x = a * torch.sigmoid(b)
        # zero padded frames so the depthwise conv does not smear pad energy
        x = x * pad_mask[..., None].to(x.dtype)
        x = self.depthwise(x.transpose(1, 2)).transpose(1, 2)
        x = x * self.bn_scale + self.bn_bias
        return self.pointwise2(F.silu(x))


def rel_sinusoid(T: int, d_model: int, device=None) -> torch.Tensor:
    """[2T-1, d_model] f32 sinusoids for relative offsets T-1 .. -(T-1).

    NeMo `RelPositionalEncoding.create_pe` layout: sin at EVEN feature
    indices, cos at ODD (interleaved) — converted `linear_pos` weights read
    this exact column order."""
    pos = torch.arange(T - 1, -T, -1, dtype=torch.float32, device=device)
    inv = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model)
    )
    ang = pos[:, None] * inv[None, :]
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(2 * T - 1, d_model)


class RelPosMHSA(nn.Module):
    """Transformer-XL relative positional multi-head self-attention with
    per-row key lengths; the attention function (the encoder's route) holds
    any limit on the context."""

    def __init__(self, cfg: ConformerConfig, device=None):
        super().__init__()
        d, H, Dh = cfg.d_model, cfg.n_heads, cfg.head_dim
        self.n_heads = H
        self.ln = _layer_norm(d, device)
        self.q = _linear(cfg, d, d, device=device)
        self.k = _linear(cfg, d, d, device=device)
        self.v = _linear(cfg, d, d, device=device)
        self.pos = _linear(cfg, d, d, bias=False, device=device)
        self.pos_bias_u = nn.Parameter(torch.zeros(H, Dh, device=device))
        self.pos_bias_v = nn.Parameter(torch.zeros(H, Dh, device=device))
        self.out = _linear(cfg, d, d, device=device)

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor, lengths: torch.Tensor,
                attention: AttentionFn | None = None) -> torch.Tensor:
        """`attention=None` picks by head width: the kernel's wrapper where
        the kernel takes Dh, the plain version elsewhere."""
        B, T, d = x.shape
        H = self.n_heads
        Dh = d // H
        if attention is None:
            attention = relpos_attention if kernel_takes_head_dim(Dh) else relpos_attention_plain
        x = self.ln(x)
        q = self.q(x).reshape(B, T, H, Dh)
        k = self.k(x).reshape(B, T, H, Dh)
        v = self.v(x).reshape(B, T, H, Dh)
        p = self.pos(pos_emb)  # [2T-1, d]

        # [B, H, T, Dh] views of the [B, T, H, Dh] projections (the JAX
        # package's Pallas layout, without the copies): the kernel reads them
        # strided and writes o in the layout the output projection reads
        qu = (q + self.pos_bias_u).transpose(1, 2)
        qw = (q + self.pos_bias_v).transpose(1, 2)
        ph = p.reshape(2 * T - 1, H, Dh).transpose(0, 1)  # [H, 2T-1, Dh]
        o = torch.empty(B, T, H, Dh, dtype=x.dtype, device=x.device)
        attention(qu, qw, k.transpose(1, 2), v.transpose(1, 2), ph, lengths, T,
                  out=o.transpose(1, 2))
        return self.out(o.reshape(B, T, d))


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ConformerConfig, device=None):
        super().__init__()
        d, d_ff = cfg.d_model, cfg.d_model * cfg.ffn_expansion
        # flat names mirror the flax tree (ffn1_ln, ffn1_fc1, ...)
        for name in ("ffn1", "ffn2"):
            setattr(self, f"{name}_ln", _layer_norm(d, device))
            setattr(self, f"{name}_fc1", _linear(cfg, d, d_ff, device=device))
            setattr(self, f"{name}_fc2", _linear(cfg, d_ff, d, device=device))
        self.mhsa = RelPosMHSA(cfg, device)
        self.conv = GLUConv(cfg, device)
        self.final_ln = _layer_norm(d, device)

    def _ffn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        h = getattr(self, f"{name}_ln")(x)
        h = F.silu(getattr(self, f"{name}_fc1")(h))
        return getattr(self, f"{name}_fc2")(h)

    def forward(self, x, pad_mask, pos_emb, lengths,
                attention: AttentionFn | None = None) -> torch.Tensor:
        x = x + 0.5 * self._ffn(x, "ffn1")
        x = x + self.mhsa(x, pos_emb, lengths, attention)
        x = x + self.conv(x, pad_mask)
        x = x + 0.5 * self._ffn(x, "ffn2")
        return self.final_ln(x)


class DwStridingSubsampling(nn.Module):
    """8x time reduction: conv stem + 2 depthwise-separable stride-2 stages."""

    def __init__(self, cfg: ConformerConfig, device=None):
        super().__init__()
        c = cfg.subsampling_channels
        self.stem = nn.Conv2d(1, c, 3, stride=2, padding=1, device=device)
        self.dw0 = nn.Conv2d(c, c, 3, stride=2, padding=1, groups=c, device=device)
        self.pw0 = nn.Conv2d(c, c, 1, device=device)
        self.dw1 = nn.Conv2d(c, c, 3, stride=2, padding=1, groups=c, device=device)
        self.pw1 = nn.Conv2d(c, c, 1, device=device)
        f8 = cfg.n_mels
        for _ in range(3):
            f8 = (f8 - 1) // 2 + 1
        self.proj = _linear(cfg, c * f8, cfg.d_model, device=device)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, n_mels, T] -> [B, T//8, d_model]."""
        x = mel.transpose(1, 2)[:, None].to(self.stem.weight.dtype)  # [B, 1, T, F]
        x = F.relu(self.stem(x))
        x = F.relu(self.pw0(self.dw0(x)))
        x = F.relu(self.pw1(self.dw1(x)))
        B, C, T8, F8 = x.shape
        # flatten CHANNEL-major (C, F) like NeMo ConvSubsampling
        x = x.permute(0, 2, 1, 3).reshape(B, T8, C * F8)
        return self.proj(x)


class ConformerEncoder(nn.Module):
    """(mel [B, n_mels, T], mel_lengths [B]) -> (f32 [B, T', D], lengths' [B] int32)."""

    def __init__(self, cfg: ConformerConfig, device=None):
        super().__init__()
        if cfg.attention_backend not in ("auto", "xla"):
            raise ValueError(
                f"attention_backend must be 'auto' or 'xla', got {cfg.attention_backend!r}")
        self.cfg = cfg
        self.subsampling = DwStridingSubsampling(cfg, device)
        for i in range(cfg.n_layers):
            self.add_module(f"block{i}", ConformerBlock(cfg, device))
        self.to(cfg.compute_dtype)

    @property
    def limited_context(self) -> bool:
        return self.cfg.att_context_left >= 0 or self.cfg.att_context_right >= 0

    def attention_route(self, mel: torch.Tensor) -> AttentionFn | None:
        """The attention path for a forward on `mel`, decided before any
        launch, as JAX's encoder decides on its config (it is a branch, never
        a fallback on failure):

        - Limited context (`att_context_left` or `att_context_right` >= 0):
          `relpos_attention_plain` over the band, with any backend and with
          or without a gradient (JAX's `use_pallas` excludes limited
          context, so its einsum path runs under the band mask).
        - `"xla"`: `relpos_attention_plain` at every head width (JAX's
          einsum path, differentiable).
        - `"auto"` with no gradient needed (grad mode off, or neither `mel`
          nor a parameter requires grad): None, i.e. `RelPosMHSA` takes the
          kernel's wrapper where the kernel takes Dh, the plain version
          elsewhere (serving).
        - `"auto"` when a gradient is needed: the plain version where JAX's
          encoder takes its einsum path (Dh != 128, or the CPU). At Dh 128 on
          the card JAX takes Pallas, which `jax.grad` cannot differentiate,
          and the port's kernel has no backward either: ValueError naming
          `attention_backend="xla"`.
        """
        cfg = self.cfg
        if self.limited_context:
            return functools.partial(relpos_attention_plain,
                                     context=(cfg.att_context_left, cfg.att_context_right))
        if cfg.attention_backend == "xla":
            return relpos_attention_plain
        needs_grad = torch.is_grad_enabled() and (
            mel.requires_grad or any(p.requires_grad for p in self.parameters()))
        if not needs_grad:
            return None
        if cfg.head_dim == 128 and mel.device.type != "cpu":
            raise ValueError(
                "attention_backend=\"auto\" takes the rel-pos attention kernel at Dh 128 on "
                "the card, which autograd cannot differentiate (nor can jax.grad the Pallas "
                "kernel); train with attention_backend=\"xla\"")
        return relpos_attention_plain

    def forward(self, mel: torch.Tensor, mel_lengths: torch.Tensor,
                attention: AttentionFn | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """`attention=None` takes `attention_route(mel)`; a caller may pass
        the kernel's wrapper or the plain version to compare the two, at full
        context only (neither takes the band)."""
        cfg = self.cfg
        if attention is None:
            attention = self.attention_route(mel)
        elif self.limited_context:
            raise ValueError("limited attention context takes the plain attention over its "
                             "band (attention_route); pass attention=None")
        x = self.subsampling(mel)
        if cfg.xscale:
            x = x * math.sqrt(cfg.d_model)
        B, T, _ = x.shape

        out_lengths = mel_lengths.to(torch.int64)
        for _ in range(3):
            out_lengths = torch.div(out_lengths + 2 - 3, 2, rounding_mode="floor") + 1
        out_lengths = torch.clamp(out_lengths, 0, T).to(torch.int32)
        pad_mask = torch.arange(T, device=x.device)[None, :] < out_lengths[:, None]

        pos_emb = rel_sinusoid(T, cfg.d_model, x.device).to(x.dtype)
        for i in range(cfg.n_layers):
            x = getattr(self, f"block{i}")(x, pad_mask, pos_emb, out_lengths, attention)

        x = x * pad_mask[..., None].to(x.dtype)
        return x.float(), out_lengths
