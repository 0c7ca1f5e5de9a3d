"""Kokoro-82M parallel TTS, in PyTorch.

Port of `fluidaudio_tpu/models/kokoro.py` (reference
`TTS/KokoroAne/Pipeline/KokoroAneSynthesizer.swift:17-160`: Albert ->
PostAlbert (duration) -> Alignment -> Prosody (F0/N) -> Noise (harmonic
source) -> Vocoder -> Tail iSTFT), as the JAX package's two programs:

  KokoroTextProgram : (input_ids, lengths, style_s, speed)
                      -> (duration [B,T], d [B,T,640], t_en [B,T,512])
  KokoroAudioProgram: (d, t_en, frame_idx, n_frames, style_s, style_timbre)
                      -> audio [B, 600*F]

Duration rounding (`expand_durations`) stays on the host, as in JAX and the
reference. Sequences run on padded buckets with explicit length masks
(masked BiLSTMs, masked instance norms in the decoder and prosody). The
generator's `AdaINResBlock1` gets no mask, so its statistics cover the whole
frame bucket, exactly as in JAX (a trained checkpoint is only valid on its
grid, `KokoroConfig.frame_buckets`).

Layout: the text side runs [B, T, C]; prosody's resblocks, the decoder and
the generator run channels-first [B, C, T] for `F.conv1d`. The transposed
convolutions are `F.conv_transpose1d` (the JAX package realises them as an
input-dilated convolution with a flipped kernel); their kernels
(`pool_kernel`, `up_kernel_i`) and the Snake `alpha{1,2}_i` are laid out by
name in `utils/weights.py`.

Flax defaults kept: LayerNorm eps 1e-6 (ALBERT's 1e-12 and the AdaIN /
AdaLayerNorm 1e-5 as written), the tanh GELU, biased variance. The harmonic
source's noise (`SourceModule`) comes from a `torch.Generator` or as given
tensors; `deterministic=True` zeroes it, as in JAX.

STFT / iSTFT (`stft_20`, `istft_20`): reflect padding, periodic Hann window,
`rfft`/`irfft`, `angle(0) = 0`; the overlap-add is a sum of `n_fft/hop`
shifted frame blocks (deterministic on the GPU, where a scatter-add with
float atomics is not), added in ascending frame order as JAX's CPU
scatter-add adds them.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from fluidaudio_tpu_torch.models.rnn import BiLstm

SAMPLE_RATE = 24_000
MAX_TOKENS = 512  # reference: <=512 IPA tokens per call w/ auto-chunking
MAX_FRAMES = 2_000  # reference KokoroAneConstants.maxAcousticFrames
HOP = 600  # samples per acoustic frame: prod(upsample_rates)*istft_hop*2
STYLE_DIM = 256  # voice-pack row: style_timbre[:128] + style_s[128:]
HARMONICS = 9  # SourceModule: the fundamental + 8 overtones


@dataclass(frozen=True)
class KokoroConfig:
    # text / predictor (kokoro-v1_0 config.json)
    vocab_size: int = 178
    d_model: int = 512  # hidden_dim
    style_dim: int = 128  # each half of the 256-d voice-pack row
    n_layer: int = 3  # DurationEncoder layers == TextEncoder conv depth
    max_dur: int = 50
    text_kernel: int = 5
    # plbert (custom ALBERT)
    albert_emb: int = 128
    albert_hidden: int = 768
    albert_heads: int = 12
    albert_inter: int = 2048
    albert_layers: int = 12
    albert_max_pos: int = 512
    # istftnet decoder
    decoder_hidden: int = 1024
    asr_res_ch: int = 64
    upsample_rates: tuple[int, ...] = (10, 6)
    upsample_kernels: tuple[int, ...] = (20, 12)
    upsample_initial: int = 512
    resblock_kernels: tuple[int, ...] = (3, 7, 11)
    resblock_dilations: tuple[tuple[int, ...], ...] = ((1, 3, 5),) * 3
    gen_n_fft: int = 20
    gen_hop: int = 5
    max_frames: int = MAX_FRAMES
    # inference frame-grid buckets (None = powers-of-two fractions of
    # max_frames); the generator's instance-norm statistics cover the whole
    # padded grid, so a trained checkpoint pins its training grid here
    frame_buckets: tuple[int, ...] | None = None
    dtype: str = "float32"
    # F0 head output scale in Hz per unit (1.0 for the shipping weights)
    f0_scale: float = 1.0
    # the generator's sin() phase head scale in radians (1.0 = parity)
    phase_scale: float = 1.0

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


# ---------------------------------------------------------------------------
# shared primitives
# ---------------------------------------------------------------------------


def linear_resize(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """F.interpolate(mode='linear', align_corners=False) over axis 1, by
    JAX's formula (edge clamp, frac clipped to [0, 1])."""
    in_len = x.shape[1]
    scale = in_len / out_len
    pos = (torch.arange(out_len, device=x.device, dtype=torch.float32) + 0.5) * scale - 0.5
    lo = torch.clamp(torch.floor(pos).long(), 0, in_len - 1)
    hi = torch.clamp(lo + 1, 0, in_len - 1)
    frac = torch.clamp(pos - lo, 0.0, 1.0)
    xl = x[:, lo]
    xh = x[:, hi]
    return xl + (xh - xl) * frac.reshape((1, out_len) + (1,) * (x.ndim - 2))


def blocked_cumsum(x: torch.Tensor, base: int = 16) -> torch.Tensor:
    """Inclusive f32 prefix sums over axis 1 of [B, n, C], in the order
    XLA:CPU sums `jnp.cumsum` (its reduce-window rewrite: running sums
    within blocks of 16, the block totals scanned the same way, recursively,
    and added back), so the sums equal JAX's bit for bit on any device.
    The harmonic source's phase is this sum times 2*pi*300, thousands of
    radians at kHz tones, where a last-ulp difference is visible in sin()."""
    B, n, C = x.shape
    if n <= base:
        acc, out = torch.zeros_like(x[:, 0]), []
        for i in range(n):
            acc = acc + x[:, i]
            out.append(acc)
        return torch.stack(out, dim=1)
    nb = -(-n // base)
    blocks = F.pad(x, (0, 0, 0, nb * base - n)).reshape(B, nb, base, C)
    acc, inner = torch.zeros_like(blocks[:, :, 0]), []
    for i in range(base):
        acc = acc + blocks[:, :, i]
        inner.append(acc)
    inner = torch.stack(inner, dim=2)  # [B, nb, base, C]
    outer = blocked_cumsum(inner[:, :, -1], base)  # running block totals
    before = torch.cat([torch.zeros_like(outer[:, :1]), outer[:, :-1]], dim=1)
    return (inner + before[:, :, None]).reshape(B, nb * base, C)[:, :n]


def _hann(n: int, device) -> torch.Tensor:
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * torch.arange(n, device=device) / n)


def stft_20(x: torch.Tensor, n_fft: int = 20, hop: int = 5
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """torch.stft(center=True) at the iSTFT head's size.

    x [B, L] -> (mag, phase) each [B, L//hop + 1, n_fft//2 + 1].
    """
    pad = n_fft // 2
    xp = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    n_frames = x.shape[1] // hop + 1
    frames = xp[:, : (n_frames - 1) * hop + n_fft].unfold(1, n_fft, hop)
    spec = torch.fft.rfft(frames * _hann(n_fft, x.device), dim=-1)
    return torch.abs(spec), torch.angle(spec)


def istft_20(mag: torch.Tensor, phase: torch.Tensor, n_fft: int = 20, hop: int = 5
             ) -> torch.Tensor:
    """torch.istft(center=True): [B, F, n_fft//2+1] x2 -> [B, (F-1)*hop]."""
    B, F_, _ = mag.shape
    spec = torch.polar(mag, phase)
    win = _hann(n_fft, mag.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win  # [B, F, n_fft]
    R = n_fft // hop
    blocks = frames.reshape(B, F_, R, hop)
    wblocks = (win * win).reshape(R, hop)
    audio = mag.new_zeros(B, F_ + R - 1, hop)
    wsum = mag.new_zeros(F_ + R - 1, hop)
    for r in range(R - 1, -1, -1):  # each output block gets its frames in ascending order
        audio[:, r : r + F_] += blocks[:, :, r]
        wsum[r : r + F_] += wblocks[r]
    audio = audio.reshape(B, -1) / torch.clamp(wsum.reshape(-1), min=1e-11)[None, :]
    pad = n_fft // 2
    return audio[:, pad : audio.shape[1] - pad]


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the block only (the transposed
    convolutions run cuDNN's backward-data algorithms, some of which add
    with atomics), so two calls on one input give the same samples on the
    card; the caller's setting is restored after."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _mask(lengths: torch.Tensor, T: int, dtype) -> torch.Tensor:
    """[B] -> [B, T] float mask of the valid prefix."""
    return (torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]).to(dtype)


class _Embed(nn.Module):
    """flax `nn.Embed`: the table is `embedding` [V, D]."""

    def __init__(self, n: int, d: int, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(n, d, device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding)


class AdaLayerNorm(nn.Module):
    """Style-conditioned LayerNorm over channels: x [B, T, C], s [B, style]
    -> (1+gamma)*LN(x) + beta."""

    def __init__(self, style_dim: int, channels: int, device=None):
        super().__init__()
        self.fc = nn.Linear(style_dim, 2 * channels, device=device)

    def forward(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.fc(s).chunk(2, dim=-1)
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        xn = (x - mean) * torch.rsqrt(var + 1e-5)
        return (1 + gamma[:, None, :]) * xn + beta[:, None, :]


class AdaIN1d(nn.Module):
    """Style-conditioned instance norm over time: x [B, C, T], s [B, style],
    mask [B, 1, T] or None -> (1+gamma)*IN(x) + beta; the statistics over the
    valid frames only when a mask is given, over all frames otherwise."""

    def __init__(self, style_dim: int, channels: int, device=None):
        super().__init__()
        self.fc = nn.Linear(style_dim, 2 * channels, device=device)

    def forward(self, x: torch.Tensor, s: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        gamma, beta = self.fc(s).chunk(2, dim=-1)
        if mask is None:
            mean = x.mean(2, keepdim=True)
            var = ((x - mean) ** 2).mean(2, keepdim=True)
        else:
            n = torch.clamp(mask.sum(2, keepdim=True), min=1.0)
            mean = (x * mask).sum(2, keepdim=True) / n
            var = (((x - mean) * mask) ** 2).sum(2, keepdim=True) / n
        xn = (x - mean) * torch.rsqrt(var + 1e-5)
        return (1 + gamma[:, :, None]) * xn + beta[:, :, None]


class AdainResBlk1d(nn.Module):
    """StyleTTS2 AdainResBlk1d on [B, C, T] (optionally 2x time upsample).

    residual: AdaIN -> lrelu(0.2) -> [depthwise ConvT x2] -> conv k3
              -> AdaIN -> lrelu -> conv k3
    shortcut: [nearest x2] -> conv 1x1 when dim changes; out = sum/sqrt(2).
    """

    def __init__(self, style_dim: int, dim_in: int, dim_out: int, upsample: bool = False,
                 device=None):
        super().__init__()
        self.dim_in, self.dim_out, self.upsample = dim_in, dim_out, upsample
        self.norm1 = AdaIN1d(style_dim, dim_in, device)
        if upsample:
            # F.conv_transpose1d layout [in, out/groups, k] (utils/weights.py)
            self.pool_kernel = nn.Parameter(torch.zeros(dim_in, 1, 3, device=device))
            self.pool_bias = nn.Parameter(torch.zeros(dim_in, device=device))
        self.conv1 = nn.Conv1d(dim_in, dim_out, 3, padding=1, device=device)
        self.norm2 = AdaIN1d(style_dim, dim_out, device)
        self.conv2 = nn.Conv1d(dim_out, dim_out, 3, padding=1, device=device)
        if dim_in != dim_out:
            self.conv1x1 = nn.Conv1d(dim_in, dim_out, 1, bias=False, device=device)

    def forward(self, x: torch.Tensor, s: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        h = F.leaky_relu(self.norm1(x, s, mask), 0.2)
        mask_r = mask
        if self.upsample:
            h = F.conv_transpose1d(h, self.pool_kernel, self.pool_bias, stride=2, padding=1,
                                   output_padding=1, groups=self.dim_in)
            mask_r = None if mask is None else mask.repeat_interleave(2, dim=2)
        h = self.conv1(h)
        h = F.leaky_relu(self.norm2(h, s, mask_r), 0.2)
        h = self.conv2(h)
        sc = x.repeat_interleave(2, dim=2) if self.upsample else x
        if self.dim_in != self.dim_out:
            sc = self.conv1x1(sc)
        out = (h + sc) / math.sqrt(2.0)
        return out if mask_r is None else out * mask_r


class AdaINResBlock1(nn.Module):
    """iSTFTNet generator resblock on [B, C, T]: dilated convs + AdaIN +
    Snake (x + (1/a)*sin^2(a*x)); `alpha{1,2}_i` laid out [1, C, 1]."""

    def __init__(self, style_dim: int, channels: int, kernel: int,
                 dilations: tuple[int, ...] = (1, 3, 5), device=None):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            self.register_parameter(f"alpha1_{i}",
                                    nn.Parameter(torch.ones(1, channels, 1, device=device)))
            self.register_parameter(f"alpha2_{i}",
                                    nn.Parameter(torch.ones(1, channels, 1, device=device)))
            self.add_module(f"adain1_{i}", AdaIN1d(style_dim, channels, device))
            self.add_module(f"conv1_{i}", nn.Conv1d(channels, channels, kernel, dilation=d,
                                                    padding=(kernel * d - d) // 2, device=device))
            self.add_module(f"adain2_{i}", AdaIN1d(style_dim, channels, device))
            self.add_module(f"conv2_{i}", nn.Conv1d(channels, channels, kernel,
                                                    padding=(kernel - 1) // 2, device=device))

    def forward(self, x: torch.Tensor, s: torch.Tensor, mask: torch.Tensor | None = None
                ) -> torch.Tensor:
        for i in range(self.n):
            a1, a2 = getattr(self, f"alpha1_{i}"), getattr(self, f"alpha2_{i}")
            xt = getattr(self, f"adain1_{i}")(x, s, mask)
            xt = xt + (1.0 / a1) * torch.sin(a1 * xt) ** 2
            xt = getattr(self, f"conv1_{i}")(xt)
            xt = getattr(self, f"adain2_{i}")(xt, s, mask)
            xt = xt + (1.0 / a2) * torch.sin(a2 * xt) ** 2
            x = x + getattr(self, f"conv2_{i}")(xt)
        return x if mask is None else x * mask


# ---------------------------------------------------------------------------
# text side: ALBERT + TextEncoder + DurationEncoder
# ---------------------------------------------------------------------------


class AlbertLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, inter: int, device=None):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(hidden, hidden, device=device)
        self.k = nn.Linear(hidden, hidden, device=device)
        self.v = nn.Linear(hidden, hidden, device=device)
        self.o = nn.Linear(hidden, hidden, device=device)
        self.attn_ln = nn.LayerNorm(hidden, eps=1e-12, device=device)
        self.ffn_in = nn.Linear(hidden, inter, device=device)
        self.ffn_out = nn.Linear(inter, hidden, device=device)
        self.out_ln = nn.LayerNorm(hidden, eps=1e-12, device=device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, T, Hd = x.shape
        hd = Hd // self.heads
        q = self.q(x).reshape(B, T, self.heads, hd)
        k = self.k(x).reshape(B, T, self.heads, hd)
        v = self.v(x).reshape(B, T, self.heads, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        probs = torch.softmax(scores + bias, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, Hd)
        x = self.attn_ln(x + self.o(ctx))
        f = self.ffn_out(F.gelu(self.ffn_in(x), approximate="tanh"))
        return self.out_ln(x + f)


class Albert(nn.Module):
    """Custom ALBERT phoneme encoder: one parameter-shared layer applied
    `albert_layers` times. (ids, lengths) -> last hidden [B, T, 768]."""

    def __init__(self, cfg: KokoroConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.word_emb = _Embed(cfg.vocab_size, cfg.albert_emb, device)
        self.pos_emb = _Embed(cfg.albert_max_pos, cfg.albert_emb, device)
        self.type_emb = _Embed(2, cfg.albert_emb, device)
        self.emb_ln = nn.LayerNorm(cfg.albert_emb, eps=1e-12, device=device)
        self.map_in = nn.Linear(cfg.albert_emb, cfg.albert_hidden, device=device)
        self.layer = AlbertLayer(cfg.albert_hidden, cfg.albert_heads, cfg.albert_inter, device)

    def forward(self, ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        T = ids.shape[1]
        pos = torch.arange(T, device=ids.device)
        x = self.word_emb(ids) + self.pos_emb(pos)[None] + self.type_emb.embedding[0]
        x = self.map_in(self.emb_ln(x))
        valid = pos[None, :] < lengths[:, None]
        bias = torch.where(valid, 0.0, -1e9)[:, None, None, :]  # [B, 1, 1, T]
        for _ in range(self.cfg.albert_layers):
            x = self.layer(x, bias)
        return x


class TextEncoder(nn.Module):
    """Kokoro TextEncoder: embed -> depth x (conv k5 + LN + lrelu) -> BiLSTM.
    (ids, lengths) -> t_en [B, T, 512]."""

    def __init__(self, cfg: KokoroConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.embed = _Embed(cfg.vocab_size, d, device)
        for i in range(cfg.n_layer):
            self.add_module(f"conv_{i}", nn.Conv1d(d, d, cfg.text_kernel,
                                                   padding=cfg.text_kernel // 2, device=device))
            self.add_module(f"ln_{i}", nn.LayerNorm(d, eps=1e-6, device=device))
        self.lstm = BiLstm(d, d // 2, device)

    def forward(self, ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        mask = _mask(lengths, ids.shape[1], torch.float32)[..., None]
        x = self.embed(ids)
        for i in range(self.cfg.n_layer):
            x = x * mask
            x = getattr(self, f"conv_{i}")(x.transpose(1, 2)).transpose(1, 2)
            x = F.leaky_relu(getattr(self, f"ln_{i}")(x), 0.2)
        x = self.lstm(x * mask, lengths)
        return x * mask


class DurationEncoder(nn.Module):
    """StyleTTS2 DurationEncoder: n_layer x (BiLSTM(d+sty -> d) then
    AdaLayerNorm(d) + re-append style). (d_en, s, lengths) -> d [B,T,640]."""

    def __init__(self, cfg: KokoroConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, sd = cfg.d_model, cfg.style_dim
        for i in range(cfg.n_layer):
            self.add_module(f"lstm_{i}", BiLstm(d + sd, d // 2, device))
            self.add_module(f"adaln_{i}", AdaLayerNorm(sd, d, device))

    def forward(self, d_en: torch.Tensor, s: torch.Tensor, lengths: torch.Tensor
                ) -> torch.Tensor:
        B, T, _ = d_en.shape
        mask = _mask(lengths, T, d_en.dtype)[..., None]
        sb = s[:, None, :].expand(B, T, s.shape[-1])
        x = torch.cat([d_en, sb], dim=-1) * mask
        for i in range(self.cfg.n_layer):
            x = getattr(self, f"lstm_{i}")(x, lengths)
            x = getattr(self, f"adaln_{i}")(x, s)
            x = torch.cat([x, sb], dim=-1) * mask
        return x


class KokoroTextProgram(nn.Module):
    """Albert + PostAlbert stages as one program.

    (input_ids [B,T], lengths [B], style_s [B,128], speed) ->
      duration [B,T] (sigmoid-summed, speed-divided; the host rounds),
      d    [B,T,640] (DurationEncoder output),
      t_en [B,T,512] (TextEncoder output).
    """

    def __init__(self, cfg: KokoroConfig | None = None, device=None):
        super().__init__()
        self.cfg = cfg = cfg or KokoroConfig()
        d = cfg.d_model
        self.albert = Albert(cfg, device)
        self.bert_encoder = nn.Linear(cfg.albert_hidden, d, device=device)
        self.dur_encoder = DurationEncoder(cfg, device)
        self.pred_lstm = BiLstm(d + cfg.style_dim, d // 2, device)
        self.duration_proj = nn.Linear(d, cfg.max_dur, device=device)
        self.text_encoder = TextEncoder(cfg, device)

    @torch.no_grad()
    def forward(self, ids: torch.Tensor, lengths: torch.Tensor, style_s: torch.Tensor,
                speed: float = 1.0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        ids = ids.long()
        with deterministic_cudnn():
            d_en = self.bert_encoder(self.albert(ids, lengths))
            d = self.dur_encoder(d_en, style_s, lengths)
            dur = self.duration_proj(self.pred_lstm(d, lengths))
            duration = torch.sigmoid(dur).sum(-1) / np.float32(speed)
            return duration, d, self.text_encoder(ids, lengths)


# ---------------------------------------------------------------------------
# audio side: alignment gather + prosody + iSTFTNet decoder
# ---------------------------------------------------------------------------


class Prosody(nn.Module):
    """F0Ntrain: shared BiLSTM then 3 AdaIN resblocks (2x upsample in the
    middle one) + 1x1 proj, for each of F0 and N.
    (en [B,F,640], s, n_frames) -> (F0 [B,2F], N [B,2F])."""

    def __init__(self, cfg: KokoroConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, sd = cfg.d_model, cfg.style_dim
        self.shared = BiLstm(d + sd, d // 2, device)
        for head in ("f0", "n"):
            self.add_module(f"{head}_0", AdainResBlk1d(sd, d, d, device=device))
            self.add_module(f"{head}_1", AdainResBlk1d(sd, d, d // 2, upsample=True,
                                                       device=device))
            self.add_module(f"{head}_2", AdainResBlk1d(sd, d // 2, d // 2, device=device))
            self.add_module(f"{head}_proj", nn.Conv1d(d // 2, 1, 1, device=device))

    def forward(self, en: torch.Tensor, s: torch.Tensor, n_frames: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        F_ = en.shape[1]
        mask = _mask(n_frames, F_, en.dtype)[:, None, :]  # [B, 1, F]
        mask2 = mask.repeat_interleave(2, dim=2)
        x = self.shared(en, n_frames).transpose(1, 2)  # [B, d, F]
        outs = []
        for head in ("f0", "n"):
            h = getattr(self, f"{head}_0")(x, s, mask)
            h = getattr(self, f"{head}_1")(h, s, mask)
            h = getattr(self, f"{head}_2")(h, s, mask2)
            h = getattr(self, f"{head}_proj")(h)
            scale = self.cfg.f0_scale if head == "f0" else 1.0
            outs.append(h[:, 0] * mask2[:, 0] * scale)
        return outs[0], outs[1]


class SourceModule(nn.Module):
    """SourceModuleHnNSF: harmonic sine source from the (sample-rate) F0
    track. f0_up [B, L] -> harmonic source [B, L].

    istftnet SineGen: per-harmonic instantaneous frequency, a random initial
    phase per harmonic (except the fundamental), frame-rate cumsum
    re-upsampled linearly, tanh(linear(sines)). The two draws, `rand_ini`
    U[0, 1) [B, 9] (its column 0 is set to 0) and `noise` N(0, 1) [B, L, 9],
    come in as tensors or from `generator` (rand_ini first);
    `deterministic=True` uses neither.
    """

    harmonic_num = HARMONICS - 1
    sine_amp = 0.1
    noise_std = 0.003
    voiced_threshold = 10.0

    def __init__(self, cfg: KokoroConfig, deterministic: bool = False, device=None):
        super().__init__()
        self.cfg, self.deterministic = cfg, deterministic
        self.l_linear = nn.Linear(HARMONICS, 1, device=device)

    def forward(self, f0_up: torch.Tensor, rand_ini: torch.Tensor | None = None,
                noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.cfg
        B, L = f0_up.shape
        upscale = int(np.prod(cfg.upsample_rates)) * cfg.gen_hop  # 300
        harm = torch.arange(1, HARMONICS + 1, device=f0_up.device, dtype=f0_up.dtype)
        fn = f0_up[..., None] * harm[None, None, :]
        rad = (fn / SAMPLE_RATE) % 1.0
        if not self.deterministic:
            if rand_ini is None:
                rand_ini = torch.rand((B, HARMONICS), generator=generator,
                                      device=f0_up.device)
                noise = torch.randn((B, L, HARMONICS), generator=generator,
                                    device=f0_up.device)
            rand_ini = rand_ini.clone()
            rand_ini[:, 0] = 0.0
            rad = torch.cat([rad[:, :1] + rand_ini[:, None, :], rad[:, 1:]], dim=1)
        # instantaneous frequency at frame rate, accumulated phase, linear x300
        rad_f = linear_resize(rad, L // upscale)
        phase = blocked_cumsum(rad_f) * 2.0 * math.pi
        phase = linear_resize(phase * upscale, L)
        sines = torch.sin(phase) * self.sine_amp
        uv = (f0_up > self.voiced_threshold).to(f0_up.dtype)[..., None]
        if self.deterministic:
            sine_waves = sines * uv
        else:
            noise_amp = uv * self.noise_std + (1 - uv) * self.sine_amp / 3
            sine_waves = sines * uv + noise_amp * noise
        return torch.tanh(self.l_linear(sine_waves))[..., 0]


class Generator(nn.Module):
    """iSTFTNet generator on [B, C, T]: 2-stage transposed-conv upsampling
    with harmonic-source injection (STFT-domain noise convs + AdaIN snake
    resblocks), snake resblocks per stage, conv_post -> (log-mag, phase)
    -> iSTFT. (x [B,512,2F], s_timbre, f0_curve [B,2F]) -> audio [B,600F]."""

    def __init__(self, cfg: KokoroConfig, deterministic: bool = False, device=None):
        super().__init__()
        self.cfg = cfg
        sd = cfg.style_dim
        n_spec = cfg.gen_n_fft + 2
        rates = cfg.upsample_rates
        self.m_source = SourceModule(cfg, deterministic, device)
        ch = cfg.upsample_initial
        for i, (r, k) in enumerate(zip(rates, cfg.upsample_kernels)):
            c_cur = cfg.upsample_initial // (2 ** (i + 1))
            if i + 1 < len(rates):
                stride_f0 = int(np.prod(rates[i + 1 :]))
                self.add_module(f"noise_conv_{i}", nn.Conv1d(
                    n_spec, c_cur, stride_f0 * 2, stride=stride_f0,
                    padding=(stride_f0 + 1) // 2, device=device))
                self.add_module(f"noise_res_{i}", AdaINResBlock1(sd, c_cur, 7, (1, 3, 5), device))
            else:
                self.add_module(f"noise_conv_{i}", nn.Conv1d(n_spec, c_cur, 1, device=device))
                self.add_module(f"noise_res_{i}", AdaINResBlock1(sd, c_cur, 11, (1, 3, 5), device))
            # F.conv_transpose1d layout [in, out, k] (utils/weights.py)
            self.register_parameter(f"up_kernel_{i}",
                                    nn.Parameter(torch.zeros(ch, c_cur, k, device=device)))
            self.register_parameter(f"up_bias_{i}", nn.Parameter(torch.zeros(c_cur, device=device)))
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernels, cfg.resblock_dilations)):
                self.add_module(f"resblock_{i}_{j}",
                                AdaINResBlock1(sd, c_cur, rk, tuple(rd), device))
            ch = c_cur
        self.conv_post = nn.Conv1d(ch, n_spec, 7, padding=3, device=device)

    def forward(self, x: torch.Tensor, s: torch.Tensor, f0_curve: torch.Tensor,
                rand_ini: torch.Tensor | None = None, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.cfg
        rates = cfg.upsample_rates
        upscale = int(np.prod(rates)) * cfg.gen_hop
        # harmonic source at sample rate -> STFT-domain [B, n_fft+2, frames]
        f0_up = f0_curve.repeat_interleave(upscale, dim=1)  # nearest x300
        har = self.m_source(f0_up, rand_ini, noise, generator)
        mag, ph = stft_20(har, cfg.gen_n_fft, cfg.gen_hop)
        har_spec = torch.cat([mag, ph], dim=-1).transpose(1, 2)

        n_res = len(cfg.resblock_kernels)
        for i, (r, k) in enumerate(zip(rates, cfg.upsample_kernels)):
            x = F.leaky_relu(x, 0.1)
            xs = getattr(self, f"noise_conv_{i}")(har_spec)
            xs = getattr(self, f"noise_res_{i}")(xs, s)
            x = F.conv_transpose1d(x, getattr(self, f"up_kernel_{i}"),
                                   getattr(self, f"up_bias_{i}"), stride=r, padding=(k - r) // 2)
            if i == len(rates) - 1:
                x = torch.cat([x[:, :, 1:2], x], dim=2)  # reflection_pad (1, 0)
            x = x + xs
            acc = 0.0
            for j in range(n_res):
                acc = acc + getattr(self, f"resblock_{i}_{j}")(x, s)
            x = acc / n_res

        x = self.conv_post(F.leaky_relu(x, 0.01)).transpose(1, 2)
        n_bins = cfg.gen_n_fft // 2 + 1
        # log-magnitudes of real audio sit well inside (-30, 8); the clip
        # only keeps random weights from inf/NaN
        spec = torch.exp(torch.clamp(x[..., :n_bins], -30.0, 8.0))
        phase = torch.sin(x[..., n_bins:]) * cfg.phase_scale
        return istft_20(spec, phase, cfg.gen_n_fft, cfg.gen_hop)


class Decoder(nn.Module):
    """iSTFTNet Decoder: F0/N stride-2 convs, encode block, 3+1 AdaIN
    decode blocks with (asr_res, F0, N) re-injection, then the Generator.
    (asr [B,F,512], F0 [B,2F], N [B,2F], s_timbre, n_frames) -> audio."""

    def __init__(self, cfg: KokoroConfig, deterministic: bool = False, device=None):
        super().__init__()
        self.cfg = cfg
        sd, dh, rc = cfg.style_dim, cfg.decoder_hidden, cfg.asr_res_ch
        self.f0_conv = nn.Conv1d(1, 1, 3, stride=2, padding=1, device=device)
        self.n_conv = nn.Conv1d(1, 1, 3, stride=2, padding=1, device=device)
        self.encode = AdainResBlk1d(sd, cfg.d_model + 2, dh, device=device)
        self.asr_res = nn.Conv1d(cfg.d_model, rc, 1, device=device)
        for i in range(3):
            self.add_module(f"decode_{i}", AdainResBlk1d(sd, dh + 2 + rc, dh, device=device))
        self.decode_3 = AdainResBlk1d(sd, dh + 2 + rc, cfg.upsample_initial, upsample=True,
                                      device=device)
        self.generator = Generator(cfg, deterministic, device)

    def forward(self, asr: torch.Tensor, f0_curve: torch.Tensor, n_curve: torch.Tensor,
                s: torch.Tensor, n_frames: torch.Tensor, rand_ini=None, noise=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        cfg = self.cfg
        mask = _mask(n_frames, asr.shape[1], asr.dtype)[:, None, :]  # [B, 1, F]
        # the feature branch sees F0 in units of f0_scale; the Hz-scale
        # curve drives the harmonic source
        f0 = self.f0_conv((f0_curve / cfg.f0_scale)[:, None, :])
        n_ = self.n_conv(n_curve[:, None, :])
        asr = asr.transpose(1, 2)
        x = torch.cat([asr, f0, n_], dim=1) * mask
        x = self.encode(x, s, mask)
        asr_res = self.asr_res(asr)
        for i in range(4):
            x = torch.cat([x, asr_res, f0, n_], dim=1)
            x = getattr(self, f"decode_{i}")(x, s, mask)
        return self.generator(x, s, f0_curve, rand_ini, noise, generator)


class KokoroAudioProgram(nn.Module):
    """Alignment + Prosody + Noise + Vocoder + Tail stages as one program.

    (d [B,T,640], t_en [B,T,512], frame_idx [B,F] (token per frame),
     n_frames [B], style_s [B,128], style_timbre [B,128]) -> audio [B, 600*F].
    The reference's one-hot alignment matmul is a gather over the padded
    frame grid. The harmonic source's draws come from `generator`, or as
    `rand_ini` / `noise` tensors. cuDNN runs its deterministic algorithms
    inside both programs (`deterministic_cudnn`).
    """

    def __init__(self, cfg: KokoroConfig | None = None, deterministic: bool = False,
                 device=None):
        super().__init__()
        self.cfg = cfg = cfg or KokoroConfig()
        self.prosody = Prosody(cfg, device)
        self.decoder = Decoder(cfg, deterministic, device)

    @torch.no_grad()
    def forward(self, d: torch.Tensor, t_en: torch.Tensor, frame_idx: torch.Tensor,
                n_frames: torch.Tensor, style_s: torch.Tensor, style_timbre: torch.Tensor,
                rand_ini: torch.Tensor | None = None, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None, with_prosody: bool = False):
        F_ = frame_idx.shape[1]
        mask = _mask(n_frames, F_, d.dtype)[..., None]
        idx = frame_idx.long()[..., None]
        en = torch.take_along_dim(d, idx, dim=1) * mask
        asr = torch.take_along_dim(t_en, idx, dim=1) * mask
        with deterministic_cudnn():
            f0, n_ = self.prosody(en, style_s, n_frames)
            audio = self.decoder(asr, f0, n_, style_timbre, n_frames, rand_ini, noise, generator)
        return (audio, f0, n_) if with_prosody else audio


@torch.no_grad()
def random_init_kokoro_(module: nn.Module, generator: torch.Generator) -> None:
    """`models.zoo.random_init_`, then the free params it does not know:
    the transposed-conv kernels LeCun-normal over their fan-in (k * in/g),
    the Snake alphas at one, as flax initialises them."""
    from fluidaudio_tpu_torch.models.zoo import random_init_

    random_init_(module, generator)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "pool_kernel" or leaf.startswith("up_kernel_"):
            in_per_group = 1 if leaf == "pool_kernel" else p.shape[0]  # [in, out/g, k]
            fan_in = in_per_group * p.shape[2]
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * fan_in ** -0.5)
        elif leaf.startswith("alpha"):
            p.fill_(1.0)


# ---------------------------------------------------------------------------
# host-side helpers
# ---------------------------------------------------------------------------


def expand_durations(durations: np.ndarray, max_frames: int) -> tuple[np.ndarray, int]:
    """Round/clamp durations and expand to a per-frame token-index map.

    Mirrors `KokoroAneSynthesizer.swift:74-86`: round, clamp >= 1, cap total
    at max_frames. Returns (frame_idx [max_frames], total_frames).
    """
    pred = np.maximum(np.rint(durations).astype(np.int64), 1)
    total = int(pred.sum())
    if total > max_frames:
        scale = max_frames / total
        pred = np.maximum((pred * scale).astype(np.int64), 1)
        total = int(min(pred.sum(), max_frames))
    idx = np.zeros(max_frames, np.int32)
    idx[:total] = np.repeat(np.arange(len(pred), dtype=np.int32), pred)[:total]
    return idx, total
