"""Peak/current RSS through the native shim (reference MachTaskSelfWrapper analog).

Port of `fluidaudio_tpu/native/sysinfo.py`. The shim is the repo's
`native/sysinfo/sysinfo.c` (reads /proc/self), built on its own with the
host C compiler at first use into
`fluidaudio_tpu_torch/_build/libsysinfo_<hash>.so` by `native/cxx.py`. A
failed build raises; unlike the JAX module, nothing falls back to
`resource` or /proc read from Python.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from fluidaudio_tpu_torch.native import cxx
from fluidaudio_tpu_torch.ops.build import BUILD_DIR

SOURCE = cxx.NATIVE_DIR / "sysinfo" / "sysinfo.c"


def library_path() -> Path:
    return cxx.library_path(SOURCE, "sysinfo", BUILD_DIR)


def build_library() -> tuple[Path, float]:
    """Compile the shim if its library is missing -> (library, seconds the
    compile took; 0.0 when it was already built). Raises on failure."""
    return cxx.build_library(SOURCE, "sysinfo", BUILD_DIR, "sysinfo")


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build the shim if needed and load it (once per process)."""
    lib = ctypes.CDLL(str(build_library()[0]))
    for name in ("fluidaudio_peak_rss_bytes", "fluidaudio_current_rss_bytes"):
        getattr(lib, name).restype = ctypes.c_longlong
        getattr(lib, name).argtypes = []
    return lib


def peak_rss_bytes() -> int:
    """The process's peak resident set size (VmHWM) in bytes; 0 where
    /proc/self/status cannot be read."""
    return int(load_library().fluidaudio_peak_rss_bytes())


def current_rss_bytes() -> int:
    """The process's resident set size now (/proc/self/statm) in bytes."""
    return int(load_library().fluidaudio_current_rss_bytes())
