"""Offline segmentation: overlapping 10 s windows -> per-speaker weights, in PyTorch.

Port of `fluidaudio_tpu/diarizer/offline/segmentation.py` (reference
`Offline/Segmentation/OfflineSegmentationProcessor`): 10 s windows at
stepRatio 0.2, powerset softmax -> per-speaker probabilities used as
embedding weights (not the online path's hard argmax), and the argmax
binary beside them.

The recording is copied to the device once; each batch of up to
`batch_size` windows is cut there by index arithmetic (zeros past the end,
as JAX's host packing pads), run through the segmentation model, and its
weights and binary come back in one copy. JAX pads every batch to
`batch_size` rows for its jit cache; eager torch runs only the real rows
(the rows are independent, so each row's result is the same).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fluidaudio_tpu_torch.diarizer.offline.types import SegmentationOptions
from fluidaudio_tpu_torch.models.pyannote_seg import POWERSET_TABLE, WINDOW_SAMPLES

SAMPLE_RATE = 16_000


@dataclass
class SegmentationChunk:
    start_seconds: float
    weights: np.ndarray  # [589, 3] per-speaker soft activity
    binary: np.ndarray  # [589, 3] hard activity (argmax powerset)


def device_windows(flat: torch.Tensor, starts: list[int], width: int = WINDOW_SAMPLES
                   ) -> torch.Tensor:
    """[N] on the device (already padded with `width` zeros) -> [len(starts),
    width] windows flat[s : s + width], cut on the device."""
    idx = torch.tensor(starts, device=flat.device)[:, None] + torch.arange(width, device=flat.device)
    return flat[idx]


def padded_on_device(samples: np.ndarray, device: torch.device,
                     pad: int = WINDOW_SAMPLES) -> torch.Tensor:
    """One host->device copy of the recording, followed by `pad` zeros."""
    flat = torch.zeros(samples.size + pad, dtype=torch.float32, device=device)
    flat[: samples.size] = torch.from_numpy(np.ascontiguousarray(samples, np.float32)).to(device)
    return flat


class OfflineSegmentationProcessor:
    def __init__(self, model: torch.nn.Module, options: SegmentationOptions):
        self.model = model
        self.options = options
        self.device = next(model.parameters()).device
        self._table = torch.as_tensor(POWERSET_TABLE, device=self.device)

    @torch.no_grad()
    def forward(self, windows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """windows [B, 160000] -> (weights [B, 589, 3], binary [B, 589, 3])."""
        logits = self.model(windows)  # [B, 589, 7]
        weights = torch.softmax(logits, dim=-1) @ self._table
        return weights, self._table[torch.argmax(logits, dim=-1)]

    def window_starts(self, total_samples: int) -> list[int]:
        win = WINDOW_SAMPLES
        step = max(1, int(win * self.options.step_ratio))
        if total_samples <= win:
            return [0]
        starts = list(range(0, total_samples - win + 1, step))
        if starts[-1] + win < total_samples:
            starts.append(total_samples - win)
        return starts

    def process(self, samples: np.ndarray, batch_size: int = 16, progress=None,
                flat: torch.Tensor | None = None) -> list[SegmentationChunk]:
        """`progress(chunks_processed, total_chunks)` fires after every
        device batch, monotone non-decreasing, ending at total. `flat`: the
        recording already on the device (`padded_on_device`)."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        if flat is None:
            flat = padded_on_device(samples, self.device)
        starts = self.window_starts(samples.size)
        chunks: list[SegmentationChunk] = []
        for i in range(0, len(starts), batch_size):
            group = starts[i : i + batch_size]
            weights, binary = self.forward(device_windows(flat, group))
            host = torch.cat([weights, binary], dim=-1).cpu().numpy()
            for r, s in enumerate(group):
                chunks.append(SegmentationChunk(start_seconds=s / SAMPLE_RATE,
                                                weights=host[r, :, :3], binary=host[r, :, 3:]))
            if progress is not None:
                progress(len(chunks), len(starts))
        return chunks
