"""TTS audio post-processing: de-ess biquad + edge fades.

Behavioral parity: reference `TTS/AudioPostProcessor` (146 LoC): gentle
high-shelf de-esser (biquad) and short fade-in/out to kill clicks.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter


class AudioPostProcessor:
    def __init__(self, sample_rate: int, deess_freq: float = 6500.0, deess_gain_db: float = -3.0,
                 fade_seconds: float = 0.01):
        self.sample_rate = sample_rate
        self.fade_samples = int(fade_seconds * sample_rate)
        self._b, self._a = _high_shelf(sample_rate, deess_freq, deess_gain_db)

    def process(self, samples: np.ndarray) -> np.ndarray:
        x = np.asarray(samples, np.float32).reshape(-1)
        if x.size == 0:
            return x
        y = lfilter(self._b, self._a, x).astype(np.float32)
        n = min(self.fade_samples, y.size // 2)
        if n > 0:
            ramp = np.linspace(0.0, 1.0, n, dtype=np.float32)
            y[:n] *= ramp
            y[-n:] *= ramp[::-1]
        peak = np.abs(y).max()
        if peak > 1.0:
            y = y / peak
        return y


def _high_shelf(fs: float, f0: float, gain_db: float, q: float = 0.707):
    """RBJ audio EQ cookbook high-shelf biquad coefficients."""
    a = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * np.pi * f0 / fs
    alpha = np.sin(w0) / (2.0 * q)
    cosw = np.cos(w0)
    sa = 2.0 * np.sqrt(a) * alpha
    b0 = a * ((a + 1) + (a - 1) * cosw + sa)
    b1 = -2 * a * ((a - 1) + (a + 1) * cosw)
    b2 = a * ((a + 1) + (a - 1) * cosw - sa)
    a0 = (a + 1) - (a - 1) * cosw + sa
    a1 = 2 * ((a - 1) - (a + 1) * cosw)
    a2 = (a + 1) - (a - 1) * cosw - sa
    return (
        np.array([b0, b1, b2]) / a0,
        np.array([1.0, a1 / a0, a2 / a0]),
    )
