"""Shared plain pieces: NeMo's log-mel frontend and the FastConformer encoder.

The frontend follows NeMo's AudioToMelSpectrogramPreprocessor: preemphasis
0.97 on the valid samples, constant center padding of n_fft / 2, a
symmetric 400-sample Hann window centered in a 512-point frame, |rfft|^2,
a Slaney mel filterbank, log(x + 2^-24) and optionally per-feature
normalisation over the valid frames (ddof 1). It uses torch.fft, not a DFT
matrix. The encoder is NeMo's FastConformer (dw-striding 8x subsampling,
Transformer-XL relative-position attention, macaron FFNs, the conv module
with folded batch norm), written as plain functions over a weight dict whose
names follow the published Flax tree. Rows are computed at the padded width
the caller gives, as a batch would be.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch.nn import functional as F

F32 = torch.float32


@contextlib.contextmanager
def true_f32():
    """TF32 off for matmuls and cuDNN inside, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ----------------------------------------------------------------- frontend


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz, logstep = 200.0 / 3, 1000.0, np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz, logstep = 200.0 / 3, 1000.0, np.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * f_sp)


def slaney_filterbank(n_fft: int, n_mels: int, sr: int) -> np.ndarray:
    """[n_mels, n_fft // 2 + 1] triangular filters, Slaney area-normalised."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]
    return w.astype(np.float32)


def log_mel(audio: torch.Tensor, lengths: torch.Tensor, n_mels: int = 128,
            normalize: bool = True, n_fft: int = 512, hop: int = 160, win: int = 400,
            sr: int = 16_000) -> tuple[torch.Tensor, torch.Tensor]:
    """audio f32 [B, N], lengths [B] -> (mel [B, n_mels, N // hop + 1], frames [B])."""
    B, N = audio.shape
    dev = audio.device
    valid = torch.arange(N, device=dev)[None, :] < lengths[:, None]
    x = torch.where(valid, audio, 0.0)
    prev = F.pad(x, (1, 0))[:, :-1]
    x = torch.where(valid, x - 0.97 * prev, 0.0)
    xp = F.pad(x, (n_fft // 2, n_fft // 2))
    T = N // hop + 1
    off = (n_fft - win) // 2
    n = torch.arange(win, dtype=torch.float64, device=dev)
    window = (0.5 - 0.5 * torch.cos(2 * math.pi * n / (win - 1))).to(F32)
    frames = xp[:, off:off + (T - 1) * hop + win].unfold(1, win, hop) * window
    spec = torch.fft.rfft(F.pad(frames, (off, n_fft - win - off)), n=n_fft)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.from_numpy(slaney_filterbank(n_fft, n_mels, sr)).to(dev)
    mel = torch.log(power @ fb.T + 2.0 ** -24)  # [B, T, n_mels]
    frames_valid = torch.clamp(lengths.long() // hop + 1, max=T)
    fv = torch.arange(T, device=dev)[None, :] < frames_valid[:, None]
    if normalize:
        m = fv[..., None].to(F32)
        cnt = torch.clamp(frames_valid.to(F32), min=2.0)[:, None, None]
        mean = (mel * m).sum(1, keepdim=True) / cnt
        std = torch.sqrt((((mel - mean) * m) ** 2).sum(1, keepdim=True) / (cnt - 1.0))
        mel = (mel - mean) / (std + 1e-5)
    mel = torch.where(fv[..., None], mel, 0.0)
    return mel.transpose(1, 2), frames_valid


# ------------------------------------------------------------------ encoder


def conformer_spec(prefix: str, enc: dict, dtype: str) -> list:
    """Weight spec of a FastConformer encoder, names as the Flax tree has them."""
    d, C, k, L = enc["d_model"], enc["subsampling_channels"], enc["conv_kernel"], enc["n_layers"]
    H, ff, nm = enc["n_heads"], enc.get("ffn_expansion", 4), enc["n_mels"]
    f8 = nm
    for _ in range(3):
        f8 = (f8 - 1) // 2 + 1
    s = [(f"{prefix}subsampling.stem.weight", (C, 1, 3, 3), "w"),
         (f"{prefix}subsampling.stem.bias", (C,), "b"),
         (f"{prefix}subsampling.dw0.weight", (C, 1, 3, 3), "w"),
         (f"{prefix}subsampling.dw0.bias", (C,), "b"),
         (f"{prefix}subsampling.pw0.weight", (C, C, 1, 1), "w"),
         (f"{prefix}subsampling.pw0.bias", (C,), "b"),
         (f"{prefix}subsampling.dw1.weight", (C, 1, 3, 3), "w"),
         (f"{prefix}subsampling.dw1.bias", (C,), "b"),
         (f"{prefix}subsampling.pw1.weight", (C, C, 1, 1), "w"),
         (f"{prefix}subsampling.pw1.bias", (C,), "b"),
         (f"{prefix}subsampling.proj.weight", (d, C * f8), "w"),
         (f"{prefix}subsampling.proj.bias", (d,), "b")]
    for i in range(L):
        b = f"{prefix}block{i}."
        for name in ("ffn1", "ffn2"):
            s += [(f"{b}{name}_ln.weight", (d,), "ln"), (f"{b}{name}_ln.bias", (d,), "b"),
                  (f"{b}{name}_fc1.weight", (ff * d, d), "w"), (f"{b}{name}_fc1.bias", (ff * d,), "b"),
                  (f"{b}{name}_fc2.weight", (d, ff * d), "w"), (f"{b}{name}_fc2.bias", (d,), "b")]
        s += [(f"{b}mhsa.ln.weight", (d,), "ln"), (f"{b}mhsa.ln.bias", (d,), "b")]
        for name in ("q", "k", "v", "out"):
            s += [(f"{b}mhsa.{name}.weight", (d, d), "w"), (f"{b}mhsa.{name}.bias", (d,), "b")]
        s += [(f"{b}mhsa.pos.weight", (d, d), "w"),
              (f"{b}mhsa.pos_bias_u", (H, d // H), "b"), (f"{b}mhsa.pos_bias_v", (H, d // H), "b"),
              (f"{b}conv.ln.weight", (d,), "ln"), (f"{b}conv.ln.bias", (d,), "b"),
              (f"{b}conv.pointwise1.weight", (2 * d, d), "w"), (f"{b}conv.pointwise1.bias", (2 * d,), "b"),
              (f"{b}conv.depthwise.weight", (d, 1, k), "w"),
              (f"{b}conv.bn_scale", (d,), "ln"), (f"{b}conv.bn_bias", (d,), "b"),
              (f"{b}conv.pointwise2.weight", (d, d), "w"), (f"{b}conv.pointwise2.bias", (d,), "b"),
              (f"{b}final_ln.weight", (d,), "ln"), (f"{b}final_ln.bias", (d,), "b")]
    return [(n, sh, kind, dtype) for n, sh, kind in s]


def rel_positions(T: int, d: int, device) -> torch.Tensor:
    """[2T-1, d] sinusoids for offsets T-1 .. -(T-1), sin at even features,
    cos at odd (NeMo RelPositionalEncoding)."""
    pos = torch.arange(T - 1, -T, -1, dtype=F32, device=device)
    inv = torch.exp(torch.arange(0, d, 2, dtype=F32, device=device) * (-math.log(10000.0) / d))
    ang = pos[:, None] * inv[None, :]
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(2 * T - 1, d)


def _ln(x, W, name):
    return F.layer_norm(x, (x.shape[-1],), W[f"{name}.weight"], W[f"{name}.bias"], 1e-5)


def _lin(x, W, name, bias=True):
    return F.linear(x, W[f"{name}.weight"], W[f"{name}.bias"] if bias else None)


def relpos_attention(x, pos, lengths, W, b, H):
    """Transformer-XL attention of one block: scores (q+u).k + shift((q+v).p)
    over sqrt(Dh), keys past each row's length masked."""
    B, T, d = x.shape
    Dh = d // H
    q = _lin(x, W, f"{b}.q").reshape(B, T, H, Dh)
    k = _lin(x, W, f"{b}.k").reshape(B, T, H, Dh)
    v = _lin(x, W, f"{b}.v").reshape(B, T, H, Dh)
    p = F.linear(pos, W[f"{b}.pos.weight"]).reshape(2 * T - 1, H, Dh)
    ac = torch.einsum("bthd,bshd->bhts", q + W[f"{b}.pos_bias_u"], k)
    raw = torch.einsum("bthd,rhd->bhtr", q + W[f"{b}.pos_bias_v"], p)
    ar = torch.arange(T, device=x.device)
    r = (ar[None, :] - ar[:, None] + T - 1).expand(B, H, T, T)
    scores = (ac + torch.take_along_dim(raw, r, dim=-1)) / math.sqrt(Dh)
    keep = ar[None, None, None, :] < lengths[:, None, None, None]
    probs = torch.softmax(torch.where(keep, scores, torch.finfo(F32).min), dim=-1)
    o = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, d)
    return _lin(o, W, f"{b}.out")


def conformer(W: dict, mel: torch.Tensor, mel_len: torch.Tensor, enc: dict
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """mel [B, n_mels, T] f32 -> (encoder output [B, T', d] f32, lengths [B])."""
    d, H = enc["d_model"], enc["n_heads"]
    C = enc["subsampling_channels"]
    s = "subsampling"
    x = mel.transpose(1, 2)[:, None]
    x = F.relu(F.conv2d(x, W[f"{s}.stem.weight"], W[f"{s}.stem.bias"], stride=2, padding=1))
    for i in (0, 1):
        x = F.conv2d(x, W[f"{s}.dw{i}.weight"], W[f"{s}.dw{i}.bias"], stride=2, padding=1, groups=C)
        x = F.relu(F.conv2d(x, W[f"{s}.pw{i}.weight"], W[f"{s}.pw{i}.bias"]))
    B, _, T, f8 = x.shape
    x = _lin(x.permute(0, 2, 1, 3).reshape(B, T, C * f8), W, f"{s}.proj") * math.sqrt(d)
    lengths = mel_len.long()
    for _ in range(3):
        lengths = torch.div(lengths - 1, 2, rounding_mode="floor") + 1
    lengths = torch.clamp(lengths, 0, T)
    pad = (torch.arange(T, device=x.device)[None, :] < lengths[:, None])[..., None].to(F32)
    pos = rel_positions(T, d, x.device)
    for i in range(enc["n_layers"]):
        b = f"block{i}"

        def ffn(h, name):
            h = F.silu(_lin(_ln(h, W, f"{b}.{name}_ln"), W, f"{b}.{name}_fc1"))
            return _lin(h, W, f"{b}.{name}_fc2")

        x = x + 0.5 * ffn(x, "ffn1")
        x = x + relpos_attention(_ln(x, W, f"{b}.mhsa.ln"), pos, lengths, W, f"{b}.mhsa", H)
        h = _lin(_ln(x, W, f"{b}.conv.ln"), W, f"{b}.conv.pointwise1")
        a, g = h.chunk(2, dim=-1)
        h = (a * torch.sigmoid(g)) * pad
        k = W[f"{b}.conv.depthwise.weight"].shape[-1]
        h = F.conv1d(h.transpose(1, 2), W[f"{b}.conv.depthwise.weight"], padding=k // 2,
                     groups=d).transpose(1, 2)
        h = h * W[f"{b}.conv.bn_scale"] + W[f"{b}.conv.bn_bias"]
        x = x + _lin(F.silu(h), W, f"{b}.conv.pointwise2")
        x = x + 0.5 * ffn(x, "ffn2")
        x = _ln(x, W, f"{b}.final_ln")
    return x * pad, lengths


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| over every element."""
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.clamp(torch.linalg.vector_norm(b.double()), min=1e-30))
