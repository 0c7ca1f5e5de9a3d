"""K-means fallback clustering (reference `Offline/Clustering/KMeansClustering`,
224 LoC): k-means++ seeding, centroid iteration, re-assignment of all
embeddings to final centroids."""

from __future__ import annotations

import numpy as np


def kmeans_cluster(
    embeddings: np.ndarray, k: int, max_iters: int = 50, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """[N, D], k -> (labels [N], centroids [k, D])."""
    x = np.asarray(embeddings, np.float64)
    n = x.shape[0]
    k = max(1, min(k, n))
    rng = np.random.RandomState(seed)

    # k-means++ seeding
    centroids = [x[rng.randint(n)]]
    for _ in range(1, k):
        d2 = np.min(
            [np.sum((x - c) ** 2, axis=1) for c in centroids], axis=0
        )
        total = d2.sum()
        if total <= 0:
            centroids.append(x[rng.randint(n)])
            continue
        probs = d2 / total
        centroids.append(x[rng.choice(n, p=probs)])
    C = np.stack(centroids)

    labels = np.zeros(n, np.int64)
    for _ in range(max_iters):
        d = ((x[:, None, :] - C[None, :, :]) ** 2).sum(axis=2)
        new_labels = d.argmin(axis=1)
        if np.array_equal(new_labels, labels) and _ > 0:
            break
        labels = new_labels
        for j in range(k):
            members = x[labels == j]
            if len(members):
                C[j] = members.mean(axis=0)
    return labels, C.astype(np.float32)
