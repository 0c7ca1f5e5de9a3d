"""Speech-like 16 kHz int16 audio, made from a seed in a few large calls.

The signal is the one `bench.py` and `chip_smoke.py::speechlike` use: white
noise at 0.1 of full scale under a 4 Hz syllabic envelope. A pool is made
once at set-up (on the card when there is one) and kept in host memory;
every recording is a slice of it, so no audio is made inside the window.
"""

from __future__ import annotations

import numpy as np
import torch

SAMPLE_RATE = 16_000


def speechlike_pool(seed: int, seconds: float, device: torch.device) -> np.ndarray:
    """-> int16 [seconds * 16 kHz]: 0.1 * N(0, 1) * 0.5 (1 + sin(2 pi 4 t))."""
    n = int(seconds * SAMPLE_RATE)
    g = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn(n, generator=g, device=device)
    t = torch.arange(n, device=device, dtype=torch.float64) / SAMPLE_RATE
    am = (0.5 * (1.0 + torch.sin(2 * np.pi * 4.0 * t))).float()
    pcm = torch.clamp(torch.round(noise * am * (0.1 * 32768.0)), -32768, 32767)
    return pcm.to(torch.int16).cpu().numpy()
