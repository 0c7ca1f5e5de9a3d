"""PLDA preprocessing: 256-d embeddings -> 128-d rho features + psi.

Behavioral parity: reference `Offline/Extraction/PLDATransform` (198 LoC):
PldaRho CoreML graph (linear transform into the PLDA latent space) + psi
(across-class variances) loaded from plda-parameters.json. Here the transform
is an explicit (mean, matrix) pair; without assets a seeded random orthogonal
projection stands in so the pipeline is runnable.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

RHO_DIM = 128


class PLDATransform:
    def __init__(self, mean: np.ndarray, transform: np.ndarray, psi: np.ndarray):
        self.mean = np.asarray(mean, np.float32)  # [256]
        self.transform = np.asarray(transform, np.float32)  # [256, 128]
        self.psi = np.asarray(psi, np.float32)  # [128] across-class variance

    @classmethod
    def load(cls, directory: str | Path) -> "PLDATransform | None":
        d = Path(directory)
        npz = d / "plda_rho.npz"
        js = d / "plda_parameters.json"
        if npz.exists():
            data = np.load(npz)
            psi = (
                np.asarray(json.loads(js.read_text())["psi"], np.float32)
                if js.exists()
                else data.get("psi")
            )
            return cls(data["mean"], data["transform"], psi)
        return None

    @classmethod
    def random_init(cls, dim: int = 256, rho_dim: int = RHO_DIM, seed: int = 0) -> "PLDATransform":
        rng = np.random.RandomState(seed)
        a = rng.randn(dim, rho_dim)
        q, _ = np.linalg.qr(a)
        psi = np.linspace(8.0, 0.5, rho_dim).astype(np.float32)  # decaying variances
        return cls(np.zeros(dim, np.float32), q.astype(np.float32), psi)

    def __call__(self, embeddings: np.ndarray) -> np.ndarray:
        """[N, 256] -> rho [N, 128]."""
        x = np.asarray(embeddings, np.float32) - self.mean[None, :]
        return x @ self.transform
