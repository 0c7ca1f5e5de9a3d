"""Inverse text normalization rule engine binding (C++).

The library is the repo's `native/itn/itn.cpp`, built on its own with the
host C++ compiler at first use into
`fluidaudio_tpu_torch/_build/libitn_<hash>.so` by `native/cxx.py` (not
through the JAX loader's cmake build into `native/build/`). A failed build
raises; nothing falls back to passing text through.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from fluidaudio_tpu_torch.native import cxx
from fluidaudio_tpu_torch.ops.build import BUILD_DIR

SOURCE = cxx.NATIVE_DIR / "itn" / "itn.cpp"


def library_path() -> Path:
    return cxx.library_path(SOURCE, "itn", BUILD_DIR)


def build_library() -> tuple[Path, float]:
    """Compile the library if it is missing -> (library, seconds the compile
    took; 0.0 when it was already built). Raises on failure."""
    return cxx.build_library(SOURCE, "itn", BUILD_DIR, "itn")


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build the library if needed and load it (once per process)."""
    return ctypes.CDLL(str(build_library()[0]))
