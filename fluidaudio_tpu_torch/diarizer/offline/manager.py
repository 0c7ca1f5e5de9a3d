"""Offline diarization pipeline, in PyTorch: segmentation -> embeddings -> PLDA
-> AHC -> VBx -> reconstruction.

Port of `fluidaudio_tpu/diarizer/offline/manager.py` (reference
`Offline/Core/OfflineDiarizerManager.swift:7,112-365`). The recording is
copied to the device once; segmentation runs in batches of 16 windows and
embedding in batches of `EmbeddingOptions.batch_size` jobs on the device;
PLDA, AHC (the native fastcluster library), VBx and the reconstruction run
on the host, as in JAX.

Weights: `checkpoint_dir` holds `segmentation.npz`, `embedding.npz` and the
PLDA (`plda_rho.npz`); `checkpoint_dir=None` reads the model cache's
`Repo.OFFLINE_DIARIZER` folder, as JAX does; a missing checkpoint leaves
seeded random weights (with a warning) drawn on `device`, and a missing
PLDA a seeded random projection. `device=None` is the GPU; pass "cpu" to
run on the CPU.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from fluidaudio_tpu_torch.diarizer.metrics import compute_der
from fluidaudio_tpu_torch.diarizer.offline.ahc import ahc_cluster
from fluidaudio_tpu_torch.diarizer.offline.embedding import OfflineEmbeddingExtractor
from fluidaudio_tpu_torch.diarizer.offline.kmeans import kmeans_cluster
from fluidaudio_tpu_torch.diarizer.offline.plda import PLDATransform
from fluidaudio_tpu_torch.diarizer.offline.reconstruction import reconstruct_segments
from fluidaudio_tpu_torch.diarizer.offline.segmentation import (
    OfflineSegmentationProcessor,
    padded_on_device,
)
from fluidaudio_tpu_torch.diarizer.offline.types import OfflineDiarizerConfig
from fluidaudio_tpu_torch.diarizer.offline.vbx import VBxClustering
from fluidaudio_tpu_torch.diarizer.types import DiarizationResult, PipelineTimings
from fluidaudio_tpu_torch.models.pyannote_seg import PyannoteSegmentation
from fluidaudio_tpu_torch.models.wespeaker import WeSpeakerEmbedder, make_fbank_frontend
from fluidaudio_tpu_torch.models.zoo import disable_tf32, load_or_init
from fluidaudio_tpu_torch.registry import DownloadUtils, Repo
from fluidaudio_tpu_torch.utils.device import resolve_device

SAMPLE_RATE = 16_000


class OfflineDiarizerManager:
    def __init__(
        self,
        config: OfflineDiarizerConfig | None = None,
        *,
        checkpoint_dir: str | Path | None = None,
        rng_seed: int = 0,
        seg_config=None,
        emb_config=None,
        device: torch.device | str | None = None,
    ):
        """`seg_config` / `emb_config` override the model sizes (default:
        the full pyannote/WeSpeaker shapes the reference ships; the trained
        tiny fixtures pass reduced configs)."""
        self.config = config or OfflineDiarizerConfig()
        self.config.validate()  # fail fast on bad stage params (reference)
        self.device = resolve_device(device)
        disable_tf32()
        seg_model = PyannoteSegmentation(*(seg_config,) if seg_config else (),
                                         device=self.device).eval()
        embedder = WeSpeakerEmbedder(*(emb_config,) if emb_config else (),
                                     device=self.device).eval()
        fbank = make_fbank_frontend(self.device)

        base = Path(checkpoint_dir) if checkpoint_dir else DownloadUtils.repo_dir(
            Repo.OFFLINE_DIARIZER
        )
        load_or_init(seg_model, base / "segmentation.npz", rng_seed, self.device,
                     "offline diarizer segmentation")
        load_or_init(embedder, base / "embedding.npz", rng_seed + 1, self.device,
                     "offline diarizer embedding")
        self.plda = PLDATransform.load(base) or PLDATransform.random_init(seed=rng_seed)

        self.segmentation = OfflineSegmentationProcessor(seg_model, self.config.segmentation)
        self.embedding = OfflineEmbeddingExtractor(embedder, fbank, self.config.embedding)
        self.vbx = VBxClustering(self.config.vbx)

    def process(self, samples: np.ndarray, progress=None) -> DiarizationResult:
        """`progress(chunks_processed, total_chunks)`: optional callback fired
        per segmentation device batch; monotone, consistent total, final
        update reaches total (reference OfflineDiarizerManager.process
        progress contract)."""
        t_total = time.perf_counter()
        samples = np.asarray(samples, np.float32).reshape(-1)
        total_seconds = samples.size / SAMPLE_RATE
        timings = PipelineTimings()

        t0 = time.perf_counter()
        flat = padded_on_device(samples, self.device)
        chunks = self.segmentation.process(samples, progress=progress, flat=flat)
        timings.segmentation_seconds = time.perf_counter() - t0

        t0 = time.perf_counter()
        embeddings, index = self.embedding.extract(samples, chunks, flat=flat)
        timings.embedding_seconds = time.perf_counter() - t0

        t0 = time.perf_counter()
        cl = self.config.clustering
        if embeddings.shape[0] == 0:
            labels = np.zeros(0, np.int64)
        elif cl.method == "kmeans":
            k = cl.num_speakers if cl.num_speakers > 0 else min(4, embeddings.shape[0])
            labels, _ = kmeans_cluster(embeddings, k)
        else:
            warm = ahc_cluster(embeddings, cl.ahc_threshold)
            if cl.method == "ahc_vbx" and embeddings.shape[0] >= 2:
                rho = self.plda(embeddings)
                result = self.vbx.refine_with_constraints(
                    rho,
                    self.plda.psi,
                    warm,
                    num_speakers=cl.num_speakers,
                    min_speakers=cl.min_speakers,
                    max_speakers=cl.max_speakers,
                )
                labels = result.labels
            else:
                labels = warm
        timings.clustering_seconds = time.perf_counter() - t0

        t0 = time.perf_counter()
        segments = reconstruct_segments(
            chunks, index, labels, total_seconds, self.config.post
        )
        timings.post_processing_seconds = time.perf_counter() - t0
        timings.total_seconds = time.perf_counter() - t_total

        n_speakers = len({s.speaker_id for s in segments})
        return DiarizationResult(segments=segments, speaker_count=n_speakers, timings=timings)

    @staticmethod
    def evaluate(reference, hypothesis, collar: float = 0.25):
        """DER/JER guardrail metric (in-library, reference DiarizationDER)."""
        return compute_der(reference, hypothesis, collar=collar)
