"""AHC warm-start clustering over the native fastcluster library.

Behavioral parity: reference `Offline/Clustering/AHCClustering.swift:40-116`:
L2-normalize embeddings, cosine threshold converted to Euclidean distance via
sqrt(2 - 2*cos), centroid-linkage dendrogram (C++ FFI), flat clusters.
"""

from __future__ import annotations

import math

import numpy as np

from fluidaudio_tpu_torch.diarizer.types import l2_normalize
from fluidaudio_tpu_torch.native.fastcluster import centroid_linkage, cut_tree


def cosine_to_euclidean_threshold(cos_threshold: float) -> float:
    """cosine *distance* threshold -> euclidean threshold on unit vectors."""
    cos_sim = 1.0 - cos_threshold
    return math.sqrt(max(0.0, 2.0 - 2.0 * cos_sim))


def ahc_cluster(embeddings: np.ndarray, cosine_threshold: float) -> np.ndarray:
    """[N, D] -> labels [N] (0..k-1). Warm start for VBx."""
    n = embeddings.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    if n == 1:
        return np.zeros(1, np.int64)
    normed = np.stack([l2_normalize(e) for e in embeddings]).astype(np.float64)
    dendrogram = centroid_linkage(normed)
    threshold = cosine_to_euclidean_threshold(cosine_threshold)
    return cut_tree(dendrogram, n, threshold)
