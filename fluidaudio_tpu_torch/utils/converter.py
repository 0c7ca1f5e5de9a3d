"""Audio normalization to the framework-wide 16 kHz mono float32 contract.

Behavioral parity: reference `Shared/AudioConverter.swift:60-124` — every
workload consumes 16 kHz mono f32; multichannel is mixed down; arbitrary input
rates are resampled (high-quality polyphase, with a linear fallback mirroring
the reference's AVAudioConverter-unavailable path). TTS emits 24 kHz
(Supertonic3: 44.1 kHz); `resample` handles that direction too.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from fluidaudio_tpu_torch.utils.audio_io import read_audio

try:
    from scipy.signal import resample_poly as _resample_poly
except Exception:  # pragma: no cover - scipy is expected in the image
    _resample_poly = None

TARGET_SAMPLE_RATE = 16_000


def mix_to_mono(samples: np.ndarray) -> np.ndarray:
    """[n, c] or [n] float32 -> [n] float32 (channel average)."""
    x = np.asarray(samples, dtype=np.float32)
    if x.ndim == 2 and x.shape[1] > 1:
        return x.mean(axis=1)
    return x.reshape(-1)


def resample(samples: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Resample mono f32 audio. Polyphase (scipy) with linear fallback."""
    x = np.asarray(samples, dtype=np.float32).reshape(-1)
    if src_rate == dst_rate or x.size == 0:
        return x
    if _resample_poly is not None:
        g = math.gcd(src_rate, dst_rate)
        return _resample_poly(x, dst_rate // g, src_rate // g).astype(np.float32)
    # Linear fallback (reference AudioConverter.swift:236 "linear-resample fallback")
    n_out = int(round(x.size * dst_rate / src_rate))
    src_pos = np.arange(n_out, dtype=np.float64) * (src_rate / dst_rate)
    i0 = np.minimum(src_pos.astype(np.int64), x.size - 1)
    i1 = np.minimum(i0 + 1, x.size - 1)
    frac = (src_pos - i0).astype(np.float32)
    return (x[i0] * (1.0 - frac) + x[i1] * frac).astype(np.float32)


class AudioConverter:
    """Normalizes files/buffers to 16 kHz mono float32."""

    def __init__(self, target_rate: int = TARGET_SAMPLE_RATE):
        self.target_rate = target_rate

    def resample_buffer(self, samples: np.ndarray, sample_rate: int) -> np.ndarray:
        mono = mix_to_mono(samples)
        return resample(mono, sample_rate, self.target_rate)

    def resample_file(self, path: str | Path) -> np.ndarray:
        samples, rate = read_audio(path)
        return self.resample_buffer(samples, rate)

    def stream_convert_to_file(
        self, path: str | Path, out_path: str | Path, chunk_seconds: float = 60.0
    ) -> int:
        """Convert a (possibly huge) audio file to a raw f32 16 kHz temp file
        in chunks. Returns total sample count.

        Powers the constant-memory disk-backed source (reference
        `Shared/AudioSourceFactory.swift:12-60`). WAV inputs stream through
        `WavStreamReader` — peak memory is O(chunk), never O(file), matching
        the reference's streaming convert (`Shared/AudioConverter.swift:372`);
        FLAC decodes whole-file first (the native decoder is one-shot).
        """
        from fluidaudio_tpu_torch.utils.audio_io import WavStreamReader

        with open(path, "rb") as f:
            is_wav = f.read(4) == b"RIFF"
        if is_wav:
            with WavStreamReader(path) as reader:
                n = reader.n_frames

                def fetch(lo: int, hi: int) -> np.ndarray:
                    frames = reader.read_frames(lo, hi - lo)
                    if frames.dtype == np.int16:
                        frames = frames.astype(np.float32) / 32768.0
                    return mix_to_mono(frames)

                return self._stream_resample_to_file(
                    fetch, n, reader.sample_rate, out_path, chunk_seconds
                )
        samples, rate = read_audio(path)  # FLAC: native decoder is one-shot
        mono = mix_to_mono(samples)
        return self._stream_resample_to_file(
            lambda lo, hi: mono[lo:hi], mono.size, rate, out_path, chunk_seconds
        )

    def _stream_resample_to_file(
        self, fetch, n_samples: int, rate: int, out_path: str | Path,
        chunk_seconds: float,
    ) -> int:
        """Chunked boundary-exact resample of `fetch(lo, hi)` source samples."""
        from math import gcd

        total = 0
        g = gcd(rate, self.target_rate)
        up, down = self.target_rate // g, rate // g
        # chunk/context aligned to the resampling ratio so per-chunk output
        # boundaries are exact; the polyphase FIR sees real neighboring
        # samples as context instead of implicit zeros (which put a click at
        # every chunk boundary of hour-long files)
        chunk = max(down, (int(chunk_seconds * rate) // down) * down)
        ctx = (4096 // down + 1) * down
        with open(out_path, "wb") as f:
            for start in range(0, n_samples, chunk):
                end = min(start + chunk, n_samples)
                lo = max(0, start - ctx)
                hi = min(n_samples, end + ctx)
                seg = resample(fetch(lo, hi), rate, self.target_rate)
                lead = (start - lo) * up // down
                want = -((-end * up) // down) - (start * up) // down
                part = seg[lead : lead + want]
                f.write(part.astype("<f4").tobytes())
                total += part.size
        return total
