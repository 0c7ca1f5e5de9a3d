"""Mimi neural audio codec (decoder + encoder), streaming, in PyTorch.

Port of `fluidaudio_tpu/models/mimi.py` (reference
`PocketTTS/Pipeline/PocketTtsSynthesizer+Mimi.swift`, the Kyutai Mimi codec):

  latent [B, latent_dim]
   -> input proj -> frame-rate transformer (LayerNorm, RoPE, LayerScale,
      ring KV cache of `trans_context` frames)
   -> x2 time upsample: depthwise causal ConvTranspose
   -> SEANet decoder: Conv k7 -> per ratio (ELU, ConvTranspose k=2r stride
      r, residual [ELU, Conv k3, ELU, Conv k1]) -> ELU, Conv k3
   -> `hop` samples per frame (1920 at the base config)

Every convolution is causal and streams with its state explicit: a Conv1d
keeps its left context ((k-1)*dilation + 1 - stride input columns), a
ConvTranspose1d the overlap tail (k - stride output columns) it adds into
the next step. The layout is channels-first ([B, C, T], states [B, C, S]);
the transformer runs [B, T, D]. `MimiDecoder.step` is a pure function of
(latent, state) -> (samples, state), so a caller can capture it in a CUDA
graph. The encoder (voice cloning) is the mirrored SEANet encoder + x2
downsample + transformer, run batched over the whole clip.

Parameter names mirror the flax tree; the streaming transposed convs'
`kernel` (`upsample`, `up_<i>`) is laid out by name in `utils/weights.py`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

SAMPLE_RATE = 24_000
FRAME_SAMPLES = 1920  # 80 ms @ 24 kHz (12.5 Hz frame rate)


@dataclass(frozen=True)
class MimiConfig:
    latent_dim: int = 32
    dim: int = 512
    n_filters: int = 64
    ratios: tuple[int, ...] = (8, 6, 5, 4)  # decoder order (upsampling)
    kernel: int = 7
    last_kernel: int = 3
    resid_kernel: int = 3
    compress: int = 2
    trans_layers: int = 8
    trans_heads: int = 8
    trans_ff: int = 2048
    trans_context: int = 250
    layer_scale: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.dim // self.trans_heads

    @property
    def hop(self) -> int:
        return 2 * int(np.prod(self.ratios))


MIMI_TEST = MimiConfig(
    latent_dim=8, dim=32, n_filters=4, ratios=(4, 3), kernel=5,
    trans_layers=2, trans_heads=4, trans_ff=64, trans_context=16,
)


# ---------------------------------------------------------------------------
# causal conv primitives with explicit streaming state
# ---------------------------------------------------------------------------


def conv_state_size(k: int, stride: int = 1, dilation: int = 1) -> int:
    return max((k - 1) * dilation + 1 - stride, 0)


def causal_conv_step(x, state, weight, bias, stride=1, dilation=1, groups=1):
    """One streaming step of a causal Conv1d: x [B, Cin, T] (T a multiple of
    stride), state [B, Cin, S] -> (y [B, Cout, T//stride], new_state)."""
    k = weight.shape[-1]
    buf = torch.cat([state, x], dim=2)
    y = F.conv1d(buf, weight, None, stride, 0, dilation, groups)
    if bias is not None:
        y = y + bias[:, None]
    keff = (k - 1) * dilation + 1
    keep = keff - stride
    return y, (buf[:, :, buf.shape[2] - keep:] if keep > 0 else buf[:, :, :0])


def causal_convtr_step(x, state, weight, bias, stride, groups=1):
    """One streaming step of a causal ConvTranspose1d: x [B, Cin, T],
    state [B, Cout, k - stride] (the carried overlap) -> (y [B, Cout,
    T*stride], new_state). `weight` is `F.conv_transpose1d`'s [in, out/g, k]."""
    k = weight.shape[-1]
    full = F.conv_transpose1d(x, weight, None, stride, 0, 0, groups)  # (T-1)*s + k
    T_out = x.shape[2] * stride
    carry = k - stride
    if carry > 0:
        full = torch.cat([full[:, :, : state.shape[2]] + state, full[:, :, state.shape[2]:]],
                         dim=2)
    y = full[:, :, :T_out]
    if bias is not None:
        y = y + bias[:, None]
    return y, full[:, :, T_out: T_out + max(carry, 0)]


class StreamConv(nn.Module):
    """Causal streaming Conv1d (params only; the state is explicit)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1, device=None):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch // groups, kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

    def state_size(self) -> int:
        return conv_state_size(self.weight.shape[-1], self.stride, self.dilation)

    def forward(self, x, state):
        return causal_conv_step(x, state, self.weight, self.bias, self.stride, self.dilation,
                                self.groups)


class StreamConvTr(nn.Module):
    """Causal streaming ConvTranspose1d (params only; the state is explicit)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, groups: int = 1,
                 device=None):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.weight = nn.Parameter(torch.zeros(in_ch, out_ch // groups, kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

    def state_size(self) -> int:
        return max(self.weight.shape[-1] - self.stride, 0)

    def forward(self, x, state):
        return causal_convtr_step(x, state, self.weight, self.bias, self.stride, self.groups)


# ---------------------------------------------------------------------------
# frame-rate transformer with ring KV cache
# ---------------------------------------------------------------------------


def rope(q: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Rotary embedding on [B, T, H, D] at absolute positions pos [B, T]."""
    D = q.shape[-1]
    half = D // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, device=q.device, dtype=torch.float32) / half))
    ang = pos.to(torch.float32)[..., None, None] * freqs  # [B, T, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    q1, q2 = q[..., :half], q[..., half:]
    return torch.cat([q1 * cos - q2 * sin, q1 * sin + q2 * cos], dim=-1)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class MimiTransformerLayer(nn.Module):
    """One frame: x [B, 1, D], kv [2, B, CTX, H, Dh] ring cache written at
    slot pos % CTX -> (y, new_kv); attends to the last min(pos+1, CTX)
    frames."""

    def __init__(self, cfg: MimiConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.dim
        self.norm1 = nn.LayerNorm(D, eps=1e-5, device=device)
        self.in_proj = nn.Linear(D, 3 * D, bias=False, device=device)
        self.out_proj = nn.Linear(D, D, bias=False, device=device)
        self.layer_scale_1 = nn.Parameter(torch.full((D,), cfg.layer_scale, device=device))
        self.norm2 = nn.LayerNorm(D, eps=1e-5, device=device)
        self.mlp_in = nn.Linear(D, cfg.trans_ff, bias=False, device=device)
        self.mlp_out = nn.Linear(cfg.trans_ff, D, bias=False, device=device)
        self.layer_scale_2 = nn.Parameter(torch.full((D,), cfg.layer_scale, device=device))

    def forward(self, x, pos, kv):
        cfg = self.cfg
        B = x.shape[0]
        H, Dh, ctx = cfg.trans_heads, cfg.head_dim, cfg.trans_context
        q, k, v = self.in_proj(self.norm1(x)).chunk(3, dim=-1)
        q = rope(q.reshape(B, 1, H, Dh), pos[:, None])
        k = rope(k.reshape(B, 1, H, Dh), pos[:, None])
        v = v.reshape(B, 1, H, Dh)
        slot = torch.remainder(pos, ctx)
        hit = (torch.arange(ctx, device=x.device)[None, :] == slot[:, None])  # [B, ctx]
        new_k = torch.where(hit[..., None, None], k, kv[0])
        new_v = torch.where(hit[..., None, None], v, kv[1])
        idx = torch.arange(ctx, device=x.device)[None, :]
        age = torch.remainder(slot[:, None] - idx, ctx)
        valid = hit | (age < torch.clamp(pos[:, None] + 1, max=ctx))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, new_k) / math.sqrt(Dh)
        scores = torch.where(valid[:, None, None, :], scores, -1e9)
        att = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), new_v)
        x = x + self.layer_scale_1 * self.out_proj(att.reshape(B, 1, cfg.dim))
        h = self.mlp_out(_gelu_tanh(self.mlp_in(self.norm2(x))))
        return x + self.layer_scale_2 * h, torch.stack([new_k, new_v])


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


class MimiDecoder(nn.Module):
    """One-frame streaming decode: `step(latent [B, latent_dim], state) ->
    (samples [B, hop], new_state)`. The state is a dict of tensors:
    `kv` [L, 2, B, CTX, H, Dh], `pos` [B], `upsample` [B, D, 2] and `convs`,
    the SEANet states in block order (conv_in, then per ratio the
    transposed conv's overlap and the two residual convs', then conv_out)."""

    def __init__(self, cfg: MimiConfig = MimiConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.input_proj = nn.Linear(cfg.latent_dim, cfg.dim, bias=False, device=device)
        self.upsample = StreamConvTr(cfg.dim, cfg.dim, 4, 2, groups=cfg.dim, device=device)
        for i in range(cfg.trans_layers):
            self.add_module(f"tr_{i}", MimiTransformerLayer(cfg, device))
        mult = 2 ** len(cfg.ratios)
        ch = cfg.n_filters * mult
        self.conv_in = StreamConv(cfg.dim, ch, cfg.kernel, device=device)
        for i, r in enumerate(cfg.ratios):
            self.add_module(f"up_{i}", StreamConvTr(ch, ch // 2, 2 * r, r, device=device))
            self.add_module(f"res_{i}_a", StreamConv(ch // 2, ch // 2 // cfg.compress,
                                                     cfg.resid_kernel, device=device))
            self.add_module(f"res_{i}_b", StreamConv(ch // 2 // cfg.compress, ch // 2, 1,
                                                     device=device))
            ch //= 2
        self.conv_out = StreamConv(ch, 1, cfg.last_kernel, device=device)

    def blocks(self) -> list[nn.Module]:
        out = [self.conv_in]
        for i in range(len(self.cfg.ratios)):
            out += [getattr(self, f"up_{i}"), getattr(self, f"res_{i}_a"),
                    getattr(self, f"res_{i}_b")]
        return out + [self.conv_out]

    def init_state(self, batch: int, device=None) -> dict:
        cfg = self.cfg
        dev = device or self.input_proj.weight.device
        zeros = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
        convs = []
        for blk in self.blocks():
            ch = blk.bias.shape[0] if isinstance(blk, StreamConvTr) else blk.weight.shape[1] * blk.groups
            convs.append(zeros(batch, ch, blk.state_size()))
        return {
            "kv": zeros(cfg.trans_layers, 2, batch, cfg.trans_context, cfg.trans_heads,
                        cfg.head_dim),
            "pos": torch.zeros((batch,), dtype=torch.int64, device=dev),
            "upsample": zeros(batch, cfg.dim, self.upsample.state_size()),
            "convs": convs,
        }

    def step(self, latent: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
        cfg = self.cfg
        x = self.input_proj(latent)[:, None, :]  # [B, 1, D]
        pos = state["pos"]
        new_kv = []
        for i in range(cfg.trans_layers):
            x, kv_i = getattr(self, f"tr_{i}")(x, pos, state["kv"][i])
            new_kv.append(kv_i)
        x, up_state = self.upsample(x.transpose(1, 2), state["upsample"])  # [B, D, 2]

        convs = iter(state["convs"])
        new_convs = []

        def run(block, x):
            y, s = block(x, next(convs))
            new_convs.append(s)
            return y

        x = run(self.conv_in, x)
        for i in range(len(cfg.ratios)):
            x = run(getattr(self, f"up_{i}"), F.elu(x))
            res = run(getattr(self, f"res_{i}_a"), F.elu(x))
            x = x + run(getattr(self, f"res_{i}_b"), F.elu(res))
        x = run(self.conv_out, F.elu(x))
        new_state = {
            "kv": torch.stack(new_kv) if new_kv else state["kv"],
            "pos": pos + 1,
            "upsample": up_state,
            "convs": new_convs,
        }
        return x[:, 0], new_state

    @torch.no_grad()
    def forward(self, latent, state):
        return self.step(latent, state)


# ---------------------------------------------------------------------------
# encoder (voice cloning), batched
# ---------------------------------------------------------------------------


class MimiEncoder(nn.Module):
    """audio [B, N] -> latents [B, N // hop, latent_dim]: the mirrored causal
    SEANet encoder, x2 depthwise downsample, the causal transformer over the
    whole sequence (window `trans_context`), output proj."""

    def __init__(self, cfg: MimiConfig = MimiConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        ch = cfg.n_filters
        self.conv_in = nn.Conv1d(1, ch, cfg.kernel, device=device)
        for i, r in enumerate(reversed(cfg.ratios)):
            self.add_module(f"res_{i}_a", nn.Conv1d(ch, ch // cfg.compress, cfg.resid_kernel,
                                                    device=device))
            self.add_module(f"res_{i}_b", nn.Conv1d(ch // cfg.compress, ch, 1, device=device))
            self.add_module(f"down_{i}", nn.Conv1d(ch, ch * 2, 2 * r, stride=r, device=device))
            ch *= 2
        self.conv_out = nn.Conv1d(ch, cfg.dim, cfg.last_kernel, device=device)
        self.downsample = nn.Conv1d(cfg.dim, cfg.dim, 4, stride=2, groups=cfg.dim, device=device)
        D = cfg.dim
        for i in range(cfg.trans_layers):
            self.add_module(f"tr_{i}_norm1", nn.LayerNorm(D, eps=1e-5, device=device))
            self.add_module(f"tr_{i}_in_proj", nn.Linear(D, 3 * D, bias=False, device=device))
            self.add_module(f"tr_{i}_out_proj", nn.Linear(D, D, bias=False, device=device))
            self.register_parameter(f"tr_{i}_ls1",
                                    nn.Parameter(torch.full((D,), cfg.layer_scale, device=device)))
            self.add_module(f"tr_{i}_norm2", nn.LayerNorm(D, eps=1e-5, device=device))
            self.add_module(f"tr_{i}_mlp_in", nn.Linear(D, cfg.trans_ff, bias=False, device=device))
            self.add_module(f"tr_{i}_mlp_out", nn.Linear(cfg.trans_ff, D, bias=False,
                                                         device=device))
            self.register_parameter(f"tr_{i}_ls2",
                                    nn.Parameter(torch.full((D,), cfg.layer_scale, device=device)))
        self.output_proj = nn.Linear(D, cfg.latent_dim, bias=False, device=device)

    @staticmethod
    def _cconv(x, conv: nn.Conv1d):
        (k,), (stride,), (dil,) = conv.kernel_size, conv.stride, conv.dilation
        return conv(F.pad(x, ((k - 1) * dil + 1 - stride, 0)))

    @torch.no_grad()
    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self._cconv(audio[:, None, :], self.conv_in)
        for i in range(len(cfg.ratios)):
            res = self._cconv(F.elu(x), getattr(self, f"res_{i}_a"))
            x = x + self._cconv(F.elu(res), getattr(self, f"res_{i}_b"))
            x = self._cconv(F.elu(x), getattr(self, f"down_{i}"))
        x = self._cconv(F.elu(x), self.conv_out)
        x = self.downsample(F.pad(x, (2, 0))).transpose(1, 2)  # [B, T, D]

        B, T, _ = x.shape
        H, Dh = cfg.trans_heads, cfg.head_dim
        t = torch.arange(T, device=x.device)
        mask = (t[:, None] >= t[None, :]) & ((t[:, None] - t[None, :]) < cfg.trans_context)
        poss = t[None].expand(B, T)
        for i in range(cfg.trans_layers):
            L = lambda n: getattr(self, f"tr_{i}_{n}")  # noqa: E731
            q, k, v = L("in_proj")(L("norm1")(x)).chunk(3, dim=-1)
            q = rope(q.reshape(B, T, H, Dh), poss)
            k = rope(k.reshape(B, T, H, Dh), poss)
            v = v.reshape(B, T, H, Dh)
            sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
            sc = torch.where(mask[None, None], sc, -1e9)
            att = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), v)
            x = x + L("ls1") * L("out_proj")(att.reshape(B, T, cfg.dim))
            x = x + L("ls2") * L("mlp_out")(_gelu_tanh(L("mlp_in")(L("norm2")(x))))
        return self.output_proj(x)


@torch.no_grad()
def random_init_mimi_(module: nn.Module, generator: torch.Generator) -> None:
    """`models.zoo.random_init_`, then what it does not know, as flax
    initialises it: the transposed-conv weights LeCun-normal over their
    fan-in (k * in/g), the layer scales at `layer_scale`."""
    from fluidaudio_tpu_torch.models.zoo import random_init_

    random_init_(module, generator)
    for m in module.modules():
        if isinstance(m, StreamConvTr):
            w = m.weight  # [in, out/g, k]
            fan_in = (1 if m.groups > 1 else w.shape[0]) * w.shape[2]
            w.copy_(torch.randn(w.shape, generator=generator, device=w.device) * fan_in ** -0.5)
        elif isinstance(m, (MimiTransformerLayer, MimiEncoder)):
            for name, p in m.named_parameters(recurse=False):
                if "ls" in name or "layer_scale" in name:
                    p.fill_(m.cfg.layer_scale)
