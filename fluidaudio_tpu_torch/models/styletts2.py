"""StyleTTS2 LibriTTS (iteration_3), in PyTorch.

Port of `fluidaudio_tpu/models/styletts2.py` (reference
`StyleTTS2/Pipeline/Synthesize/StyleTTS2Synthesizer.swift:33-133`), as the
JAX package's four programs:

  StyleTts2TextProgram    : (ids, lengths) -> (bert_dur [B,T,768],
                            d_en [B,T,512], t_en [B,T,512])
  StyleTts2StyleProgram   : (ref_mel, mel_frames, bert_dur, lengths,
                            noise_init, noises_aux) -> (s_pred, ref_s) [B,256]
                            (two 2-D conv style encoders, then the ADPM2
                            sampler over the Karras schedule: 4 trips of
                            two denoiser calls, unrolled)
  StyleTts2PredictProgram : (d_en, s128, lengths) -> (d [B,T,640],
                            dur_logits [B,T,50])
  StyleTts2AcousticProgram: (d, t_en, frame_idx, n_frames, s128, ref128)
                            -> audio [B, 600*F + 1]

The text side, the duration encoder and the F0/N prosody are Kokoro's
modules (`models/kokoro.py`: the Kokoro-82M graph is a StyleTTS2 fork).
The decoder is StyleTTS2's HiFi-GAN: the harmonic source at the sample
rate injected through strided noise convolutions (no STFT), AdaIN Snake
resblocks, then lrelu -> ReflectionPad1d((1, 0)) -> conv_post -> tanh.

The style encoders run [B, C, n_mels, T] for `F.conv2d` (flax runs NHWC:
`utils/weights.py` lays the kernels out `[out, in, kh, kw]`); the decoder
and the generator run channels-first [B, C, T].

The harmonic source (`HifiSourceModule`) sums its phase over the samples
in XLA:CPU's order (`kokoro.blocked_cumsum`, bit-equal to JAX's
`jnp.cumsum`), then takes it mod 1 cycle. Its two draws (`rand_ini`, then
`noise`) come as tensors or from a `torch.Generator`; the manager runs it
deterministic, as JAX's does. Host-side glue (`blend_style`,
`round_durations`, `generator_output_length`) is JAX's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from fluidaudio_tpu_torch.models.flax_attention import FlaxAttention
from fluidaudio_tpu_torch.models.kokoro import (
    AdaINResBlock1,
    AdainResBlk1d,
    Albert,
    DurationEncoder,
    Prosody as KokoroProsody,
    TextEncoder,
    _mask,
    blocked_cumsum,
    deterministic_cudnn,
)
from fluidaudio_tpu_torch.models.rnn import BiLstm

SAMPLE_RATE = 24_000
# samples per duration frame: the predictor's 2x upsample times the
# generator's 300x factorization
HOP = 600
STYLE_DIM = 256  # ref/prosody halves of 128 each (refSplit)
DIFFUSION_STEPS = 5
SIGMA_MIN = 1e-4
SIGMA_MAX = 3.0
RHO = 9.0
SIGMA_DATA = 0.2  # KDiffusion EDM preconditioning (upstream sigma_data)
MAX_FRAMES = 2_000
HARMONICS = 9  # HifiSourceModule: the fundamental + 8 overtones


@dataclass(frozen=True)
class StyleTts2Config:
    # text / predictor (upstream config_libritts.yml)
    vocab_size: int = 178
    d_model: int = 512
    style_dim: int = 128
    n_layer: int = 3
    max_dur: int = 50
    text_kernel: int = 5
    # plbert (same custom ALBERT the Kokoro fork kept)
    albert_emb: int = 128
    albert_hidden: int = 768
    albert_heads: int = 12
    albert_inter: int = 2048
    albert_layers: int = 12
    albert_max_pos: int = 512
    # style encoders (StarGANv2 ResBlk stack)
    style_dim_in: int = 64
    style_max_conv_dim: int = 512
    n_mels: int = 80
    # style diffusion denoiser (transformer)
    diff_width: int = 512
    diff_layers: int = 3
    diff_heads: int = 8
    # hifigan decoder
    decoder_hidden: int = 1024
    asr_res_ch: int = 64
    upsample_rates: tuple[int, ...] = (10, 5, 3, 2)
    upsample_kernels: tuple[int, ...] = (20, 11, 7, 4)
    upsample_initial: int = 512
    resblock_kernels: tuple[int, ...] = (3, 7, 11)
    resblock_dilations: tuple[tuple[int, ...], ...] = ((1, 3, 5),) * 3
    max_frames: int = MAX_FRAMES
    max_tokens: int = 512
    dtype: str = "float32"
    # F0 head output scale in Hz (1.0 for real checkpoints; the trained
    # tiny fixture sets 500.0)
    f0_scale: float = 1.0

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


STYLETTS2_BASE = StyleTts2Config()
STYLETTS2_TEST = StyleTts2Config(
    d_model=32, style_dim=16, n_layer=1, max_dur=8,
    albert_emb=8, albert_hidden=24, albert_heads=2, albert_inter=32,
    albert_layers=2,
    style_dim_in=8, style_max_conv_dim=16,
    diff_width=32, diff_layers=1, diff_heads=2,
    decoder_hidden=32, asr_res_ch=8,
    upsample_rates=(10, 5), upsample_kernels=(20, 11),
    upsample_initial=16, resblock_kernels=(3,),
    resblock_dilations=((1, 3),),
    max_frames=64, max_tokens=64,
)


# ---------------------------------------------------------------------------
# ref_encoder: two StarGANv2-style 2-D conv style encoders over the ref mel
# ---------------------------------------------------------------------------


class ResBlk2d(nn.Module):
    """StarGANv2 ResBlk (normalize=False) on [B, C, H, W]:
    lrelu -> conv3x3 -> pool -> lrelu -> conv3x3, shortcut pool (+ 1x1 when
    the width changes), sum / sqrt(2)."""

    def __init__(self, dim_in: int, dim_out: int, downsample: bool = True, device=None):
        super().__init__()
        self.downsample = downsample
        self.conv1 = nn.Conv2d(dim_in, dim_in, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(dim_in, dim_out, 3, padding=1, device=device)
        if dim_in != dim_out:
            self.conv1x1 = nn.Conv2d(dim_in, dim_out, 1, bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.leaky_relu(x, 0.2))
        if self.downsample:
            h = F.avg_pool2d(h, 2, 2)
        h = self.conv2(F.leaky_relu(h, 0.2))
        sc = F.avg_pool2d(x, 2, 2) if self.downsample else x
        if hasattr(self, "conv1x1"):
            sc = self.conv1x1(sc)
        return (h + sc) / math.sqrt(2.0)


class StyleEncoder2d(nn.Module):
    """mel [B, n_mels, T] (+frames) -> style [B, style_dim]: conv3x3 stem ->
    4 downsampling ResBlks -> lrelu -> conv5x5 (valid) -> average over the
    frequency rows and the valid time columns (floor(frames/16) - 4,
    clamped >= 1) -> lrelu -> linear."""

    def __init__(self, cfg: StyleTts2Config, device=None):
        super().__init__()
        self.stem = nn.Conv2d(1, cfg.style_dim_in, 3, padding=1, device=device)
        dim = cfg.style_dim_in
        for i in range(4):
            dim_out = min(dim * 2, cfg.style_max_conv_dim)
            self.add_module(f"res{i}", ResBlk2d(dim, dim_out, device=device))
            dim = dim_out
        self.conv5 = nn.Conv2d(dim, dim, 5, device=device)
        self.unshared = nn.Linear(dim, cfg.style_dim, device=device)

    def forward(self, mel: torch.Tensor, mel_frames: torch.Tensor) -> torch.Tensor:
        x = self.stem(mel[:, None])  # [B, C, n_mels, T]
        for i in range(4):
            x = getattr(self, f"res{i}")(x)
        x = self.conv5(F.leaky_relu(x, 0.2))
        n_freq, Bt = x.shape[2], x.shape[3]
        valid_t = torch.clamp(torch.div(mel_frames, 16, rounding_mode="floor") - 4, min=1)
        tmask = _mask(valid_t, Bt, x.dtype)  # [B, W]
        x = torch.sum(x * tmask[:, None, None, :], dim=(2, 3))
        x = x / (n_freq * torch.clamp(valid_t, min=1).to(x.dtype))[:, None]
        return self.unshared(F.leaky_relu(x, 0.2))


# ---------------------------------------------------------------------------
# style diffusion: transformer denoiser + ADPM2 / Karras sampler
# ---------------------------------------------------------------------------


def karras_sigmas(n: int, sigma_min=SIGMA_MIN, sigma_max=SIGMA_MAX, rho=RHO) -> np.ndarray:
    """`StyleTTS2DiffusionSchedule.karrasSigmas` (+0.0 pad terminator)."""
    i = np.arange(n, dtype=np.float64)
    s = (sigma_max ** (1 / rho) + i / (n - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    return np.concatenate([s, [0.0]]).astype(np.float32)


class StyleDenoiser(nn.Module):
    """Transformer denoiser for the 256-d style vector: the vector as a
    length-256 sequence of scalars, FiLM-modulated by (sigma, ref_s)
    features, cross-attending to the BERT tokens; EDM preconditioning."""

    def __init__(self, cfg: StyleTts2Config, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.diff_width
        self.time_in = nn.Linear(d, d, device=device)
        self.feat_in = nn.Linear(2 * cfg.style_dim, d, device=device)
        self.map_in = nn.Linear(d, d, device=device)
        self.map_out = nn.Linear(d, d, device=device)
        self.to_in = nn.Linear(1, d, device=device)
        self.pos = nn.Parameter(torch.zeros(2 * cfg.style_dim, d, device=device))
        self.ctx_proj = nn.Linear(cfg.albert_hidden, d, device=device)
        for i in range(cfg.diff_layers):
            self.add_module(f"mod{i}", nn.Linear(d, 2 * d, device=device))
            self.add_module(f"ln_a{i}", nn.LayerNorm(d, eps=1e-6, device=device))
            self.add_module(f"self{i}", FlaxAttention(d, cfg.diff_heads, device))
            self.add_module(f"ln_c{i}", nn.LayerNorm(d, eps=1e-6, device=device))
            self.add_module(f"cross{i}", FlaxAttention(d, cfg.diff_heads, device))
            self.add_module(f"ln_f{i}", nn.LayerNorm(d, eps=1e-6, device=device))
            self.add_module(f"ff1_{i}", nn.Linear(d, 2 * d, device=device))
            self.add_module(f"ff2_{i}", nn.Linear(2 * d, d, device=device))
        self.ln_out = nn.LayerNorm(d, eps=1e-6, device=device)
        self.to_out = nn.Linear(d, 1, device=device)

    def forward(self, x, sigma, embedding, emb_mask, features):
        d = self.cfg.diff_width
        c_skip = SIGMA_DATA ** 2 / (sigma ** 2 + SIGMA_DATA ** 2)
        c_out = sigma * SIGMA_DATA * torch.rsqrt(sigma ** 2 + SIGMA_DATA ** 2)
        c_in = torch.rsqrt(sigma ** 2 + SIGMA_DATA ** 2)
        c_noise = torch.log(torch.clamp(sigma, min=1e-20)) * 0.25

        half = d // 2
        freqs = torch.exp(-math.log(10000.0)
                          * torch.arange(half, device=x.device, dtype=torch.float32) / half)
        t = torch.cat([torch.sin(c_noise[:, None] * freqs), torch.cos(c_noise[:, None] * freqs)],
                      dim=-1)
        t = F.silu(self.time_in(t))
        f = F.silu(self.feat_in(features))
        mapping = self.map_out(F.silu(self.map_in(t + f)))

        h = self.to_in((c_in[:, None] * x)[..., None]) + self.pos[None]
        ctx = self.ctx_proj(embedding)
        ctx_mask = emb_mask[:, None, None, :]
        for i in range(self.cfg.diff_layers):
            L = lambda n: getattr(self, f"{n}{i}")  # noqa: E731
            scale, shift = L("mod")(F.silu(mapping))[:, None, :].chunk(2, dim=-1)
            hn = L("ln_a")(h) * (1 + scale) + shift
            h = h + L("self")(hn)
            h = h + L("cross")(L("ln_c")(h), ctx, ctx_mask)
            ff = getattr(self, f"ff1_{i}")(L("ln_f")(h))
            h = h + getattr(self, f"ff2_{i}")(F.gelu(ff, approximate="tanh"))
        out = self.to_out(self.ln_out(h))[..., 0]
        return c_skip[:, None] * x + c_out[:, None] * out


def adpm2_sample(denoise_fn, noise_init: torch.Tensor, noises_aux: torch.Tensor,
                 num_steps: int = DIFFUSION_STEPS) -> torch.Tensor:
    """ADPM2 (DPM-Solver-2 ancestral) over the Karras schedule, JAX's
    arithmetic: the schedule in f64 on the host, each step's scalars as f32
    operands. `noise_init` [B,256] seeds x = sigma_max * noise; step k
    consumes `noises_aux[k]`."""
    sigmas = karras_sigmas(num_steps)
    x = noise_init * float(sigmas[0])
    B = x.shape[0]
    for k in range(num_steps - 1):
        sigma, sigma_next = float(sigmas[k]), float(sigmas[k + 1])
        sig = torch.full((B,), sigma, dtype=x.dtype, device=x.device)
        sigma_up = math.sqrt(sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2) / sigma ** 2)
        sigma_down = math.sqrt(sigma_next ** 2 - sigma_up ** 2)
        sigma_mid = (sigma + sigma_down) / 2  # ADPM2Sampler rho=1 midpoint
        d = (x - denoise_fn(x, sig)) / sigma
        x_mid = x + d * (sigma_mid - sigma)
        sig_mid = torch.full((B,), sigma_mid, dtype=x.dtype, device=x.device)
        d_mid = (x_mid - denoise_fn(x_mid, sig_mid)) / sigma_mid
        x = x + d_mid * (sigma_down - sigma)
        x = x + noises_aux[k] * sigma_up
    return x


# the F0/N predictor is Kokoro's module (F0Ntrain is the same in both graphs)
ProsodyF0N = KokoroProsody


# ---------------------------------------------------------------------------
# HiFi-GAN decoder (waveform head, harmonic source injection)
# ---------------------------------------------------------------------------


class HifiSourceModule(nn.Module):
    """SourceModuleHnNSF at 24 kHz: 8 harmonics + fundamental, tanh(linear).
    f0_up [B, L] -> source [B, L]. The phase is the running sum of the
    per-sample frequency in cycles, mod 1 cycle. `deterministic=True` uses
    no draws; otherwise `rand_ini` U[0, 1) [B, 9] (column 0 set to 0) and
    `noise` N(0, 1) [B, L, 9] come as tensors or from `generator`."""

    sine_amp = 0.1
    noise_std = 0.003
    voiced_threshold = 10.0

    def __init__(self, deterministic: bool = False, device=None):
        super().__init__()
        self.deterministic = deterministic
        self.l_linear = nn.Linear(HARMONICS, 1, device=device)

    def forward(self, f0_up: torch.Tensor, rand_ini: torch.Tensor | None = None,
                noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B, L = f0_up.shape
        harm = torch.arange(1, HARMONICS + 1, device=f0_up.device, dtype=f0_up.dtype)
        rad = torch.remainder(f0_up[..., None] * harm / SAMPLE_RATE, 1.0)
        if not self.deterministic:
            if rand_ini is None:
                rand_ini = torch.rand((B, HARMONICS), generator=generator, device=f0_up.device)
                noise = torch.randn((B, L, HARMONICS), generator=generator,
                                    device=f0_up.device)
            rand_ini = rand_ini.clone()
            rand_ini[:, 0] = 0.0
            rad = torch.cat([rad[:, :1] + rand_ini[:, None, :], rad[:, 1:]], dim=1)
        phase = torch.remainder(blocked_cumsum(rad), 1.0) * 2.0 * math.pi
        sines = torch.sin(phase) * self.sine_amp
        uv = (f0_up > self.voiced_threshold).to(f0_up.dtype)[..., None]
        if self.deterministic:
            sine_waves = sines * uv
        else:
            noise_amp = uv * self.noise_std + (1 - uv) * self.sine_amp / 3
            sine_waves = sines * uv + noise_amp * noise
        return torch.tanh(self.l_linear(sine_waves))[..., 0]


class HifiGenerator(nn.Module):
    """StyleTTS2 hifigan.py Generator on [B, C, T]:
    (x [B,512,2F], s, f0_curve [B,2F]) -> audio [B, 2F*prod(rates)+1]."""

    def __init__(self, cfg: StyleTts2Config, deterministic: bool = False, device=None):
        super().__init__()
        self.cfg = cfg
        sd = cfg.style_dim
        rates = cfg.upsample_rates
        self.m_source = HifiSourceModule(deterministic, device)
        ch = cfg.upsample_initial
        for i, (r, k) in enumerate(zip(rates, cfg.upsample_kernels)):
            c_cur = cfg.upsample_initial // (2 ** (i + 1))
            if i + 1 < len(rates):
                stride_f0 = int(np.prod(rates[i + 1:]))
                self.add_module(f"noise_conv_{i}", nn.Conv1d(
                    1, c_cur, stride_f0 * 2, stride=stride_f0,
                    padding=(stride_f0 + 1) // 2, device=device))
                self.add_module(f"noise_res_{i}", AdaINResBlock1(sd, c_cur, 7, (1, 3, 5), device))
            else:
                self.add_module(f"noise_conv_{i}", nn.Conv1d(1, c_cur, 1, device=device))
                self.add_module(f"noise_res_{i}", AdaINResBlock1(sd, c_cur, 11, (1, 3, 5), device))
            # F.conv_transpose1d layout [in, out, k] (utils/weights.py)
            self.register_parameter(f"up_kernel_{i}",
                                    nn.Parameter(torch.zeros(ch, c_cur, k, device=device)))
            self.register_parameter(f"up_bias_{i}", nn.Parameter(torch.zeros(c_cur, device=device)))
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernels, cfg.resblock_dilations)):
                self.add_module(f"resblock_{i}_{j}",
                                AdaINResBlock1(sd, c_cur, rk, tuple(rd), device))
            ch = c_cur
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3, device=device)

    def forward(self, x: torch.Tensor, s: torch.Tensor, f0_curve: torch.Tensor,
                rand_ini=None, noise=None, generator: torch.Generator | None = None
                ) -> torch.Tensor:
        cfg = self.cfg
        rates = cfg.upsample_rates
        f0_up = f0_curve.repeat_interleave(int(np.prod(rates)), dim=1)
        har = self.m_source(f0_up, rand_ini, noise, generator)[:, None, :]  # [B, 1, L]
        n_res = len(cfg.resblock_kernels)
        for i, (r, k) in enumerate(zip(rates, cfg.upsample_kernels)):
            x = F.leaky_relu(x, 0.1)
            xs = getattr(self, f"noise_res_{i}")(getattr(self, f"noise_conv_{i}")(har), s)
            x = F.conv_transpose1d(x, getattr(self, f"up_kernel_{i}"),
                                   getattr(self, f"up_bias_{i}"), stride=r, padding=(k - r) // 2)
            x = x + xs
            acc = 0.0
            for j in range(n_res):
                acc = acc + getattr(self, f"resblock_{i}_{j}")(x, s)
            x = acc / n_res
        x = F.leaky_relu(x, 0.01)
        x = torch.cat([x[:, :, 1:2], x], dim=2)  # ReflectionPad1d((1, 0))
        return torch.tanh(self.conv_post(x)[:, 0])


class HifiDecoder(nn.Module):
    """hifigan.py Decoder: F0/N stride-2 convs, encode block, 3+1 AdaIN
    decode blocks with (asr_res, F0, N) re-injection, then HifiGenerator.
    (asr [B,F,512], F0 [B,2F], N [B,2F], s_ref, n_frames) -> audio."""

    def __init__(self, cfg: StyleTts2Config, deterministic: bool = False, device=None):
        super().__init__()
        sd, dh, rc = cfg.style_dim, cfg.decoder_hidden, cfg.asr_res_ch
        self.f0_conv = nn.Conv1d(1, 1, 3, stride=2, padding=1, device=device)
        self.n_conv = nn.Conv1d(1, 1, 3, stride=2, padding=1, device=device)
        self.encode = AdainResBlk1d(sd, cfg.d_model + 2, dh, device=device)
        self.asr_res = nn.Conv1d(cfg.d_model, rc, 1, device=device)
        for i in range(3):
            self.add_module(f"decode_{i}", AdainResBlk1d(sd, dh + 2 + rc, dh, device=device))
        self.decode_3 = AdainResBlk1d(sd, dh + 2 + rc, cfg.upsample_initial, upsample=True,
                                      device=device)
        self.generator = HifiGenerator(cfg, deterministic, device)

    def forward(self, asr, f0_curve, n_curve, s, n_frames, rand_ini=None, noise=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        mask = _mask(n_frames, asr.shape[1], asr.dtype)[:, None, :]  # [B, 1, F]
        f0 = self.f0_conv(f0_curve[:, None, :])
        n_ = self.n_conv(n_curve[:, None, :])
        asr = asr.transpose(1, 2)
        x = self.encode(torch.cat([asr, f0, n_], dim=1) * mask, s, mask)
        asr_res = self.asr_res(asr)
        for i in range(4):
            x = getattr(self, f"decode_{i}")(torch.cat([x, asr_res, f0, n_], dim=1), s, mask)
        return self.generator(x, s, f0_curve, rand_ini, noise, generator)


# ---------------------------------------------------------------------------
# the four programs
# ---------------------------------------------------------------------------


class StyleTts2TextProgram(nn.Module):
    """(ids [B,T], lengths [B]) -> (bert_dur [B,T,768], d_en [B,T,512],
    t_en [B,T,512])."""

    def __init__(self, cfg: StyleTts2Config = STYLETTS2_BASE, device=None):
        super().__init__()
        self.cfg = cfg
        self.albert = Albert(cfg, device)
        self.bert_encoder = nn.Linear(cfg.albert_hidden, cfg.d_model, device=device)
        self.text_encoder = TextEncoder(cfg, device)

    @torch.no_grad()
    def forward(self, ids: torch.Tensor, lengths: torch.Tensor):
        ids = ids.long()
        with deterministic_cudnn():
            bert_dur = self.albert(ids, lengths)
            return bert_dur, self.bert_encoder(bert_dur), self.text_encoder(ids, lengths)


class StyleTts2StyleProgram(nn.Module):
    """(ref_mel [B,80,Tm], mel_frames [B], bert_dur [B,T,768], lengths [B],
    noise_init [B,256], noises_aux [S-1,B,256]) -> (s_pred, ref_s) [B,256];
    ref_s = concat(style_encoder, predictor_encoder)."""

    def __init__(self, cfg: StyleTts2Config = STYLETTS2_BASE, device=None):
        super().__init__()
        self.cfg = cfg
        self.style_encoder = StyleEncoder2d(cfg, device)
        self.predictor_encoder = StyleEncoder2d(cfg, device)
        self.diffusion = StyleDenoiser(cfg, device)

    @torch.no_grad()
    def forward(self, ref_mel, mel_frames, bert_dur, lengths, noise_init, noises_aux):
        ref_s = torch.cat([self.style_encoder(ref_mel, mel_frames),
                           self.predictor_encoder(ref_mel, mel_frames)], dim=-1)
        T = bert_dur.shape[1]
        emb_mask = torch.arange(T, device=bert_dur.device)[None, :] < lengths[:, None]

        def denoise(x, sig):
            return self.diffusion(x, sig, bert_dur, emb_mask, ref_s)

        return adpm2_sample(denoise, noise_init, noises_aux), ref_s


class StyleTts2PredictProgram(nn.Module):
    """(d_en [B,T,512], s128 prosody style, lengths) -> (d [B,T,640],
    dur_logits [B,T,max_dur]); the host rounds sum(sigmoid(logits))."""

    def __init__(self, cfg: StyleTts2Config = STYLETTS2_BASE, device=None):
        super().__init__()
        self.cfg = cfg
        self.dur_encoder = DurationEncoder(cfg, device)
        self.pred_lstm = BiLstm(cfg.d_model + cfg.style_dim, cfg.d_model // 2, device)
        self.duration_proj = nn.Linear(cfg.d_model, cfg.max_dur, device=device)

    @torch.no_grad()
    def forward(self, d_en, s, lengths):
        with deterministic_cudnn():
            d = self.dur_encoder(d_en, s, lengths)
            return d, self.duration_proj(self.pred_lstm(d, lengths))


class StyleTts2AcousticProgram(nn.Module):
    """(d [B,T,640], t_en [B,T,512], frame_idx [B,F], n_frames [B], s128
    prosody, ref128 acoustic) -> audio [B, F*600 + 1]: the alignment as a
    gather over the padded frame grid, the causal `_hifigan_shift` as a
    first-frame-preserving roll of both, then prosody and the decoder."""

    def __init__(self, cfg: StyleTts2Config = STYLETTS2_BASE, deterministic: bool = False,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.prosody = ProsodyF0N(cfg, device)
        self.decoder = HifiDecoder(cfg, deterministic, device)

    @torch.no_grad()
    def forward(self, d, t_en, frame_idx, n_frames, s, ref, rand_ini=None, noise=None,
                generator: torch.Generator | None = None, with_prosody: bool = False):
        F_ = frame_idx.shape[1]
        mask = _mask(n_frames, F_, d.dtype)[..., None]
        idx = frame_idx.long()[..., None]
        en = torch.take_along_dim(d, idx, dim=1) * mask
        asr = torch.take_along_dim(t_en, idx, dim=1) * mask
        en = torch.cat([en[:, :1], en[:, :-1]], dim=1)
        asr = torch.cat([asr[:, :1], asr[:, :-1]], dim=1)
        with deterministic_cudnn():
            f0, n_ = self.prosody(en, s, n_frames)
            audio = self.decoder(asr, f0, n_, ref, n_frames, rand_ini, noise, generator)
        return (audio, f0, n_) if with_prosody else audio


# ---------------------------------------------------------------------------
# host-side glue
# ---------------------------------------------------------------------------


def blend_style(s_pred, ref_s, alpha=0.3, beta=0.7):
    """alpha/beta blend of the 128/128 style split
    (`StyleTTS2GlueOps.blendStyle`). Returns (ref128, s128)."""
    half = s_pred.shape[-1] // 2
    ref = alpha * s_pred[:, :half] + (1 - alpha) * ref_s[:, :half]
    s = beta * s_pred[:, half:] + (1 - beta) * ref_s[:, half:]
    return ref, s


def generator_output_length(cfg: StyleTts2Config, in_frames: int) -> int:
    """Exact HifiGenerator output length for `in_frames` (=2F) input frames."""
    L = in_frames
    for r, k in zip(cfg.upsample_rates, cfg.upsample_kernels):
        p = (k - r) // 2
        L = (L - 1) * r - 2 * p + k
    return L + 1


def round_durations(dur_logits: np.ndarray, n_tokens: int) -> np.ndarray:
    """`GlueOps.roundDurations`: sum(sigmoid) over the duration-bin axis,
    round half-away-from-zero, clamp >= 1. dur_logits [T, max_dur] -> [n]."""
    x = np.asarray(dur_logits[:n_tokens], np.float64)
    s = np.sum(1.0 / (1.0 + np.exp(-x)), axis=-1)
    return np.maximum(np.floor(s + 0.5).astype(np.int64), 1)
