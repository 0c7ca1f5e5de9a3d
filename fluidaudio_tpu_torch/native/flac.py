"""Native FLAC decoder binding (C++), int16 output.

Port of `fluidaudio_tpu/native/flac.py`. The decoder is the repo's
`native/flac/flac.cpp` (written from RFC 9639; libc/libstdc++ only), built
on its own with the host C++ compiler at first use into
`fluidaudio_tpu_torch/_build/libflac_<hash>.so`, keyed by the hash of the
source, its header and the flags, as `ops/build.py` keys the CUDA kernels.
The library is written to a temporary file and moved into place with
`os.replace`, so concurrent first uses (test workers) cannot see a partial
library. A failed build raises; nothing falls back.

Output is interleaved int16 [frames, channels], which rides the int16 PCM
path of `utils/audio_source.py` unchanged.
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

import numpy as np

from fluidaudio_tpu_torch.ops.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "flac" / "flac.cpp"
HEADER = SOURCE.with_name("flac.h")
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

_ERRORS = {
    1: "not a FLAC stream",
    2: "truncated stream",
    3: "unsupported FLAC feature",
    4: "corrupt stream",
    5: "allocation failure",
}


class FlacError(ValueError):
    pass


def compiler() -> str:
    """The host C++ compiler: $CXX, else c++ / g++ / clang++ on PATH."""
    found = os.environ.get("CXX") or next(
        (c for c in ("c++", "g++", "clang++") if shutil.which(c)), None)
    if not found:
        raise RuntimeError("no C++ compiler found for the FLAC decoder: set CXX")
    return found


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes() + HEADER.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libflac_{tag}.so"


def build_library() -> tuple[Path, float]:
    """Compile the decoder if its library is missing -> (library, seconds the
    compile took; 0.0 when it was already built). Raises on failure."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"FLAC decoder build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build the decoder if needed and load it (once per process)."""
    lib = ctypes.CDLL(str(build_library()[0]))
    lib.flac_decode_int16.restype = ctypes.c_int
    lib.flac_decode_int16.argtypes = [
        ctypes.c_char_p,
        ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.flac_free.restype = None
    lib.flac_free.argtypes = [ctypes.c_void_p]
    return lib


def decode_flac(data: bytes) -> tuple[np.ndarray, int]:
    """Decode an in-memory FLAC stream -> (int16 [n, channels], sample_rate).

    Sources wider than 16 bits are rounded down to 16; narrower are shifted
    up. Raises FlacError on malformed input, RuntimeError when the decoder
    cannot be built.
    """
    lib = load_library()
    out_ptr = ctypes.POINTER(ctypes.c_int16)()
    frames = ctypes.c_uint64()
    rate = ctypes.c_uint32()
    channels = ctypes.c_uint32()
    bits = ctypes.c_uint32()
    rc = lib.flac_decode_int16(
        data, len(data), ctypes.byref(out_ptr), ctypes.byref(frames), ctypes.byref(rate),
        ctypes.byref(channels), ctypes.byref(bits),
    )
    if rc != 0:
        raise FlacError(f"FLAC decode failed: {_ERRORS.get(rc, rc)}")
    try:
        n = int(frames.value) * int(channels.value)
        pcm = np.ctypeslib.as_array(out_ptr, shape=(n,)).copy()
    finally:
        lib.flac_free(out_ptr)
    return pcm.reshape(int(frames.value), int(channels.value)), int(rate.value)


def read_flac_raw(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a FLAC file -> (int16 [n, channels], sample_rate)."""
    return decode_flac(Path(path).read_bytes())
