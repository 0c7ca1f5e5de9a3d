"""Build a native library of the repo (`native/<name>/<name>.cpp`, or a C
source `native/<name>/<name>.c`) with the host compiler, at first use, into
`fluidaudio_tpu_torch/_build/` (the caller's `build_dir`).

C++ sources go through the C++ compiler (`$CXX`, else c++ / g++ / clang++)
with `CXX_FLAGS`; C sources through the C compiler (`$CC`, else cc / gcc /
clang) with `C_FLAGS`. The library is `lib<stem>_<hash>.so`, keyed by the
hash of the source, its header where it has one, and the flags, as
`ops/build.py` keys the CUDA kernels. It is compiled to a temporary file and
moved into place with `os.replace`, so concurrent first uses (test workers)
cannot see a partial library. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
C_FLAGS = ("-std=c11", "-O2", "-shared", "-fPIC")


def _find(env: str, names: tuple[str, ...], what: str) -> str:
    found = os.environ.get(env) or next((c for c in names if shutil.which(c)), None)
    if not found:
        raise RuntimeError(f"no {what} compiler found for the native libraries: set {env}")
    return found


def compiler() -> str:
    """The host C++ compiler: $CXX, else c++ / g++ / clang++ on PATH."""
    return _find("CXX", ("c++", "g++", "clang++"), "C++")


def c_compiler() -> str:
    """The host C compiler: $CC, else cc / gcc / clang on PATH."""
    return _find("CC", ("cc", "gcc", "clang"), "C")


def _is_c(source: Path) -> bool:
    return source.suffix == ".c"


def library_path(source: Path, stem: str, build_dir: Path) -> Path:
    header = source.with_suffix(".h")
    flags = C_FLAGS if _is_c(source) else CXX_FLAGS
    tag = hashlib.sha256(source.read_bytes()
                         + (header.read_bytes() if header.exists() else b"")
                         + " ".join(flags).encode()).hexdigest()[:16]
    return build_dir / f"lib{stem}_{tag}.so"


def build_library(source: Path, stem: str, build_dir: Path, label: str) -> tuple[Path, float]:
    """Compile `source` if its library is missing -> (library, seconds the
    compile took; 0.0 when it was already built). Raises RuntimeError
    ("<label> build failed ...") on failure."""
    lib = library_path(source, stem, build_dir)
    if lib.exists():
        return lib, 0.0
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cc, flags = (c_compiler(), C_FLAGS) if _is_c(source) else (compiler(), CXX_FLAGS)
    cmd = [cc, *flags, "-I", str(source.parent), "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{label} build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0
