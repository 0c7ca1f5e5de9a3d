"""Log-mel spectrogram frontend with NeMo numerical parity, in PyTorch.

Port of `fluidaudio_tpu/ops/mel.py::MelFrontend` (the NeMo
AudioToMelSpectrogramPreprocessor recipe):
  - preemphasis 0.97 (seedable with the previous chunk's last sample)
  - center zero-padding by n_fft/2 ('constant', NOT reflect), or none
    (`center=False`, the streaming frontend)
  - symmetric Hann window of win_length=400 centered inside the n_fft=512 frame
  - power spectrum |DFT|^2, 257 bins
  - Slaney-normalized mel filterbank, 128 bins, fmin 0, fmax sr/2
  - log with additive floor 2^-24 (or clamped mode)
  - optional NeMo 'per_feature' normalization (ddof=1 over valid frames)

Precision: the windowed DFT is one [T, win] x [win, 2*bins] f32 matmul over
frames cut with `unfold`. Near-silence bins go wrong unless that product
accumulates in true f32, so the frontend never uses a convolution (cuDNN
runs f32 convolutions in TF32 by default) and the model entry points turn
TF32 off for matmuls and cuDNN alike (`models/zoo.py`).

The host-side constants (filterbank, window) are the JAX package's own,
copied here so this module imports no JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fluidaudio_tpu_torch.utils.device import resolve_device

# ---------------------------------------------------------------------------
# Filterbank / window construction (host-side constants)
# ---------------------------------------------------------------------------


def hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    mels = f / f_sp
    log_region = f >= min_log_hz
    mels = np.where(log_region, min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    freqs = m * f_sp
    log_region = m >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


def slaney_mel_filterbank(
    n_fft: int, n_mels: int, sample_rate: int, f_min: float = 0.0, f_max: float | None = None
) -> np.ndarray:
    """Triangular mel filterbank with Slaney area normalization.
    Returns [n_mels, n_fft//2+1] f32."""
    if f_max is None:
        f_max = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel_slaney(f_min), hz_to_mel_slaney(f_max), n_mels + 2)
    hz_pts = mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def hann_window(win_length: int, periodic: bool = False) -> np.ndarray:
    """Hann window; symmetric by default (NeMo), periodic for librosa paths."""
    if periodic:
        n = np.arange(win_length, dtype=np.float64)
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    else:
        if win_length == 1:
            w = np.ones(1)
        else:
            n = np.arange(win_length, dtype=np.float64)
            w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win_length - 1))
    return w.astype(np.float32)


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 16_000
    n_mels: int = 128
    n_fft: int = 512
    hop_length: int = 160
    win_length: int = 400
    preemph: float = 0.97
    log_floor: float = 2.0**-24
    log_floor_mode: str = "additive"  # "additive" | "clamped"
    window_periodic: bool = False
    center: bool = True  # constant (zero) center padding by n_fft//2
    normalize: str | None = None  # None | "per_feature"
    mag_power: float = 2.0
    f_max: float | None = None  # mel filterbank upper edge (None = sr/2)

    @property
    def n_freq_bins(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        """NeMo frame-count convention: center pad n_fft//2 each side."""
        if self.center:
            return num_samples // self.hop_length + 1
        return max(0, 1 + (num_samples - self.win_length) // self.hop_length)


# NeMo-parity presets for the model families (SURVEY.md §2.4: three mel recipes)
NEMO_PARAKEET = MelConfig(normalize="per_feature")
NEMO_EOU = MelConfig(normalize=None)  # parakeet_realtime_eou_120m: normalize "NA"


# ---------------------------------------------------------------------------
# NumPy golden reference (direct per-frame FFT) — used by tests
# ---------------------------------------------------------------------------


def log_mel_numpy(audio: np.ndarray, cfg: MelConfig, last_sample: float = 0.0) -> np.ndarray:
    """Direct (slow) implementation. Returns [n_mels, T] float32."""
    x = np.asarray(audio, dtype=np.float32).copy()
    if cfg.preemph > 0 and x.size:
        shifted = np.concatenate([[np.float32(last_sample)], x[:-1]])
        x = x - cfg.preemph * shifted
    pad = cfg.n_fft // 2 if cfg.center else 0
    xp = np.pad(x, (pad, pad))
    T = cfg.num_frames(audio.shape[0])
    win = hann_window(cfg.win_length, cfg.window_periodic)
    off = (cfg.n_fft - cfg.win_length) // 2
    fb = slaney_mel_filterbank(cfg.n_fft, cfg.n_mels, cfg.sample_rate, f_max=cfg.f_max)
    out = np.zeros((cfg.n_mels, T), dtype=np.float32)
    for t in range(T):
        frame = np.zeros(cfg.n_fft, dtype=np.float32)
        start = t * cfg.hop_length + off
        seg = xp[start : start + cfg.win_length]
        frame[off : off + seg.size] = seg * win[: seg.size]
        spec = np.fft.rfft(frame)
        power = (spec.real**2 + spec.imag**2).astype(np.float32)
        if cfg.mag_power != 2.0:
            power = power ** (cfg.mag_power / 2.0)
        mel = fb @ power
        if cfg.log_floor_mode == "additive":
            out[:, t] = np.log(mel + cfg.log_floor)
        else:
            out[:, t] = np.log(np.maximum(mel, cfg.log_floor))
    if cfg.normalize == "per_feature" and T > 1:
        mean = out.mean(axis=1, keepdims=True)
        std = out.std(axis=1, ddof=1, keepdims=True)
        out = (out - mean) / (std + 1e-5)
    return out


# ---------------------------------------------------------------------------
# Torch implementation (batched)
# ---------------------------------------------------------------------------


class MelFrontend:
    """Precomputes the windowed-DFT and mel matrices once per device.

    The windowed real DFT is folded into a single [win, 2*bins] matrix:
      W[i, f]        = hann[i] * cos(2*pi*f*(i+off)/n_fft)
      W[i, bins + f] = -hann[i] * sin(2*pi*f*(i+off)/n_fft)
    so power = re^2 + im^2 comes from one frames @ W matmul.
    """

    def __init__(self, cfg: MelConfig = MelConfig(), device: torch.device | str | None = None):
        """`device=None` is the GPU (RuntimeError without one); pass "cpu"
        to run on the CPU."""
        self.cfg = cfg
        self.device = resolve_device(device)
        win = hann_window(cfg.win_length, cfg.window_periodic).astype(np.float64)
        off = (cfg.n_fft - cfg.win_length) // 2
        f = np.arange(cfg.n_freq_bins, dtype=np.float64)
        i = np.arange(cfg.win_length, dtype=np.float64) + off
        phase = 2.0 * np.pi * np.outer(i, f) / cfg.n_fft  # [win, bins]
        dft = np.concatenate([win[:, None] * np.cos(phase), -win[:, None] * np.sin(phase)], axis=1)
        self._dft = torch.tensor(dft, dtype=torch.float32, device=self.device)
        self._melfb_t = torch.tensor(
            slaney_mel_filterbank(cfg.n_fft, cfg.n_mels, cfg.sample_rate, f_max=cfg.f_max).T,
            device=self.device,
        )  # [bins, n_mels]

    def num_frames(self, num_samples: int) -> int:
        return self.cfg.num_frames(num_samples)

    @torch.no_grad()
    def __call__(
        self,
        audio: torch.Tensor,
        lengths: torch.Tensor | None = None,
        last_samples: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """audio [B, N] f32 (+ lengths [B]) -> (mel [B, n_mels, T], mel_lengths [B] int32).

        Frames beyond a row's valid length are zeroed and excluded from
        per-feature normalization, matching NeMo's masked stats.
        """
        cfg = self.cfg
        if audio.ndim == 1:
            audio = audio[None, :]
        audio = audio.float()
        B, N = audio.shape
        dev = audio.device
        if lengths is None:
            lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
        if last_samples is None:
            last_samples = torch.zeros((B,), dtype=audio.dtype, device=dev)

        # zero out samples beyond each row's length so pad never leaks energy
        valid = torch.arange(N, device=dev)[None, :] < lengths[:, None]
        x = torch.where(valid, audio, 0.0)

        if cfg.preemph > 0:
            shifted = torch.cat([last_samples[:, None].to(x.dtype), x[:, :-1]], dim=1)
            x = x - cfg.preemph * torch.where(valid, shifted, 0.0)

        pad = cfg.n_fft // 2 if cfg.center else 0
        xp = torch.nn.functional.pad(x, (pad, pad))

        T = cfg.num_frames(N)
        off = (cfg.n_fft - cfg.win_length) // 2
        nb = cfg.n_freq_bins
        # frame t covers xp[t*hop + off : t*hop + off + win]. Past the end the
        # JAX gather clamps its index to the last sample, so the tail repeats
        # that sample: it is a center-pad zero with center=True, but a real
        # sample in the streaming (center=False) frontend, whose last frame
        # reaches `off` samples past the window
        need = off + (T - 1) * cfg.hop_length + cfg.win_length
        if need > xp.shape[1]:
            xp = torch.cat([xp, xp[:, -1:].expand(B, need - xp.shape[1])], dim=1)
        frames = xp[:, off:need].unfold(1, cfg.win_length, cfg.hop_length)  # [B, T, win]
        spec = torch.matmul(frames, self._dft)  # [B, T, 2*bins], true f32
        power = spec[..., :nb] ** 2 + spec[..., nb:] ** 2
        if cfg.mag_power != 2.0:
            power = power ** (cfg.mag_power / 2.0)
        mel = torch.matmul(power, self._melfb_t)  # [B, T, n_mels]

        if cfg.log_floor_mode == "additive":
            logmel = torch.log(mel + cfg.log_floor)
        else:
            logmel = torch.log(torch.clamp(mel, min=cfg.log_floor))

        lengths = lengths.to(torch.int64)
        if cfg.center:
            mel_lengths = lengths // cfg.hop_length + 1
        else:
            mel_lengths = torch.clamp(1 + (lengths - cfg.win_length) // cfg.hop_length, min=0)
        mel_lengths = torch.clamp(mel_lengths, max=T).to(torch.int32)

        frame_valid = torch.arange(T, device=dev)[None, :] < mel_lengths[:, None]  # [B, T]
        if cfg.normalize == "per_feature":
            mask = frame_valid[..., None].to(logmel.dtype)
            n = torch.clamp(mel_lengths.to(logmel.dtype)[:, None, None], min=2.0)
            mean = torch.sum(logmel * mask, dim=1, keepdim=True) / n
            var = torch.sum(((logmel - mean) * mask) ** 2, dim=1, keepdim=True) / (n - 1.0)
            logmel = (logmel - mean) / (torch.sqrt(var) + 1e-5)

        logmel = torch.where(frame_valid[..., None], logmel, 0.0)
        return logmel.transpose(1, 2), mel_lengths  # [B, n_mels, T]
