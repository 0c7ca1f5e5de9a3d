"""Centroid-linkage AHC binding (C++).

Port of `fluidaudio_tpu/native/fastcluster.py`'s native path. The library
is the repo's `native/fastcluster/fastcluster.cpp`, built on its own with the
host C++ compiler at first use into
`fluidaudio_tpu_torch/_build/libfastcluster_<hash>.so` by `native/cxx.py`
(not through the JAX loader's cmake build into `native/build/`). A failed
build raises; nothing falls back. SciPy's `linkage(method="centroid")` and
`fcluster` are the plain versions the tests hold it against.

`centroid_linkage` builds the squared-distance matrix with one BLAS product
and runs the Lance-Williams centroid merges in C++ (O(n) per merge), the
JAX wrapper's fast path; `cut_tree` cuts the dendrogram into flat labels.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from fluidaudio_tpu_torch.native import cxx
from fluidaudio_tpu_torch.ops.build import BUILD_DIR

SOURCE = cxx.NATIVE_DIR / "fastcluster" / "fastcluster.cpp"

_ERRORS = {1: "invalid argument", 2: "allocation failure", 3: "NaN in input", 4: "overflow"}
_DOUBLE_P = ctypes.POINTER(ctypes.c_double)


class FastClusterError(RuntimeError):
    pass


def library_path() -> Path:
    return cxx.library_path(SOURCE, "fastcluster", BUILD_DIR)


def build_library() -> tuple[Path, float]:
    """Compile the library if it is missing -> (library, seconds the compile
    took; 0.0 when it was already built). Raises on failure."""
    return cxx.build_library(SOURCE, "fastcluster", BUILD_DIR, "fastcluster")


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build the library if needed and load it (once per process)."""
    lib = ctypes.CDLL(str(build_library()[0]))
    lib.fastcluster_centroid_linkage_lw.restype = ctypes.c_int
    lib.fastcluster_centroid_linkage_lw.argtypes = [_DOUBLE_P, ctypes.c_long, _DOUBLE_P]
    lib.fastcluster_cut_tree.restype = ctypes.c_long
    lib.fastcluster_cut_tree.argtypes = [
        _DOUBLE_P, ctypes.c_long, ctypes.c_double, ctypes.POINTER(ctypes.c_long)]
    return lib


def native_available() -> bool:
    """True when the library builds and loads."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def centroid_linkage(points: np.ndarray) -> np.ndarray:
    """[n, d] float -> SciPy dendrogram [(n-1), 4] (centroid linkage)."""
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n = pts.shape[0]
    if n < 2:
        return np.zeros((0, 4), np.float64)
    lib = load_library()
    sq = np.einsum("ij,ij->i", pts, pts)
    # in place: broadcast temporaries would be 3x n^2 doubles
    sqdist = pts @ pts.T
    sqdist *= -2.0
    sqdist += sq[:, None]
    sqdist += sq[None, :]
    np.maximum(sqdist, 0.0, out=sqdist)
    out = np.zeros((n - 1, 4), np.float64)
    rc = lib.fastcluster_centroid_linkage_lw(
        sqdist.ctypes.data_as(_DOUBLE_P), n, out.ctypes.data_as(_DOUBLE_P))
    if rc != 0:
        raise FastClusterError(f"fastcluster: {_ERRORS.get(rc, rc)}")
    return out


def cut_tree(dendrogram: np.ndarray, n: int, threshold: float) -> np.ndarray:
    """Flat cluster labels (0..k-1, order of first appearance) at threshold."""
    if n <= 0:
        return np.zeros(0, np.int64)
    if n == 1 or dendrogram.shape[0] == 0:
        return np.zeros(n, np.int64)
    lib = load_library()
    den = np.ascontiguousarray(dendrogram, np.float64)
    labels = np.zeros(n, np.int64)
    k = lib.fastcluster_cut_tree(den.ctypes.data_as(_DOUBLE_P), n, float(threshold),
                                 labels.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    if k < 0:
        raise FastClusterError(f"cut_tree: {_ERRORS.get(-k, k)}")
    return labels
