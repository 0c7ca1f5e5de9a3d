"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `csrc/` compiles on its own into a shared library with a
plain C interface, `_build/lib<stem>_<hash>.so`, keyed by the hash of the
source and the flags, so an edited source builds anew and an unchanged one
is reused. `build(...)` starts one nvcc per source that is not built yet,
all at once, and waits for every one of them, and returns what ptxas
reported of each kernel (registers, shared memory, spills). Nothing builds
at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# no --use_fast_math: the int8 kernel's quantisation relies on IEEE division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source: Path) -> Path:
    tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{tag}.so"


def build(*sources: Path) -> dict[str, tuple[float, str]]:
    """Compile every source whose library is missing, one nvcc each, all
    started together. -> {source name: (seconds until its library was
    ready, nvcc's ptxas report)}, (0.0, "") for one already built. Raises if
    any nvcc fails."""
    t0 = time.perf_counter()
    built = {s.name: (0.0, "") for s in sources}
    running = []
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((src, lib, tmp, cmd, proc))
    failures = []
    for src, lib, tmp, cmd, proc in running:
        _, err = proc.communicate()
        built[src.name] = (time.perf_counter() - t0, err)
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("\n".join(failures))
    return built


@functools.cache
def load_library(source: Path) -> ctypes.CDLL:
    """Build `source` if needed and load its library (once per process)."""
    build(source)
    return ctypes.CDLL(str(library_path(source)))
