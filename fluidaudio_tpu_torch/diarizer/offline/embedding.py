"""Offline embedding extraction with scipy-zoom weight interpolation, in PyTorch.

Port of `fluidaudio_tpu/diarizer/offline/embedding.py` (reference
`Offline/Extraction/OfflineEmbeddingExtractor` + `WeightInterpolation`):
one masked embedding per (window, speaker) pair above the activity floor,
overlap frames suppressed, batched.

Each batch of up to `batch_size` jobs cuts its windows on the device from
the recording copied there once, runs the fbank and the embedder, and comes
back in one copy. JAX pads every batch to `batch_size` rows; eager torch
runs only the real rows (independent rows: the same embeddings).
"""

from __future__ import annotations

import numpy as np
import torch

from fluidaudio_tpu_torch.diarizer.offline.segmentation import (
    SegmentationChunk,
    device_windows,
    padded_on_device,
)
from fluidaudio_tpu_torch.diarizer.offline.types import EmbeddingOptions
from fluidaudio_tpu_torch.models.pyannote_seg import NUM_SPEAKERS, WINDOW_SAMPLES
from fluidaudio_tpu_torch.models.wespeaker import WeSpeakerEmbedder
from fluidaudio_tpu_torch.ops.mel import MelFrontend


def interpolate_weights(weights: np.ndarray, target_len: int) -> np.ndarray:
    """[T] -> [target_len] linear interpolation with half-pixel alignment
    (scipy.ndimage.zoom mode='nearest' alignment, reference WeightInterpolation)."""
    src_len = weights.shape[0]
    if src_len == target_len:
        return weights.astype(np.float32)
    if target_len <= 0 or src_len == 0:  # reference returns empty
        return np.zeros(max(target_len, 0), np.float32)
    scale = src_len / target_len
    # half-pixel centers: out i samples src at (i + 0.5) * scale - 0.5
    pos = (np.arange(target_len) + 0.5) * scale - 0.5
    pos = np.clip(pos, 0, src_len - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, src_len - 1)
    frac = (pos - lo).astype(np.float32)
    return (weights[lo] * (1 - frac) + weights[hi] * frac).astype(np.float32)


class OfflineEmbeddingExtractor:
    def __init__(self, embedder: WeSpeakerEmbedder, fbank: MelFrontend,
                 options: EmbeddingOptions):
        self.embedder = embedder
        self.fbank = fbank
        self.options = options
        self.device = next(embedder.parameters()).device

    @torch.no_grad()
    def forward(self, windows: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """windows [B, W], masks [B, T_mel] -> [B, D]."""
        mel, _ = self.fbank(windows)  # [B, 80, T]
        return self.embedder(mel.transpose(1, 2), masks)

    def extract(
        self, samples: np.ndarray, chunks: list[SegmentationChunk],
        flat: torch.Tensor | None = None,
    ) -> tuple[np.ndarray, list[tuple[int, int]]]:
        """Returns (embeddings [M, D], index [(chunk_idx, speaker_idx)]).

        Skips (window, speaker) pairs under the activity floor (reference skip
        strategies, OfflineEmbeddingExtractor.swift:177-545). `flat`: the
        recording already on the device (`padded_on_device`).
        """
        samples = np.asarray(samples, np.float32).reshape(-1)
        mel_frames = self.fbank.num_frames(WINDOW_SAMPLES)

        jobs: list[tuple[int, int, np.ndarray]] = []
        for ci, chunk in enumerate(chunks):
            # clean-frame weighting: suppress overlap frames
            overlap = chunk.binary.sum(axis=1) >= 2
            for s in range(NUM_SPEAKERS):
                w = chunk.weights[:, s] * (~overlap)
                if w.sum() < self.options.min_active_frames:
                    continue
                jobs.append((ci, s, interpolate_weights(w, mel_frames)))

        dim = self.embedder.cfg.embedding_dim
        if not jobs:
            return np.zeros((0, dim), np.float32), []
        if flat is None:
            flat = padded_on_device(samples, self.device)

        B = self.options.batch_size
        embeddings = []
        for i in range(0, len(jobs), B):
            group = jobs[i : i + B]
            starts = [int(chunks[ci].start_seconds * 16000) for ci, _, _ in group]
            mask = torch.from_numpy(np.stack([w for _, _, w in group])).to(self.device)
            embeddings.append(self.forward(device_windows(flat, starts), mask).cpu().numpy())
        return np.concatenate(embeddings), [(ci, s) for ci, s, _ in jobs]
