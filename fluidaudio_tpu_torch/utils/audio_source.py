"""Constant-memory audio sample sources.

Behavioral parity: reference `Shared/AudioSampleSource.swift:3-80` (protocol with
`sampleCount`/`copySamples`) and `Shared/AudioSourceFactory.swift:12-60`
(array-backed + mmap disk-backed f32 implementations). The disk-backed source
lets hour-scale files be windowed without holding them in RAM.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Protocol

import numpy as np

from fluidaudio_tpu_torch.utils.converter import AudioConverter, TARGET_SAMPLE_RATE


class AudioSampleSource(Protocol):
    @property
    def sample_count(self) -> int: ...

    def copy_samples(self, start: int, count: int) -> np.ndarray:
        """Return float32 [count]; out-of-range tail is zero-filled."""
        ...

    def copy_samples_raw(self, start: int, count: int) -> np.ndarray:
        """Return [count] in the source's native dtype (int16 for PCM16
        sources, float32 otherwise); out-of-range tail is zero-filled.

        int16 rows are shipped to the device as-is and upcast there
        (scale 1/32768) — half the host->device bytes."""
        ...


class ArrayAudioSource:
    """In-memory source; int16 input is kept int16 (PCM transfer path),
    everything else is normalized to float32."""

    def __init__(self, samples: np.ndarray):
        arr = np.asarray(samples)
        if arr.dtype != np.int16:
            arr = arr.astype(np.float32)
        self._samples = arr.reshape(-1)

    @property
    def sample_count(self) -> int:
        return int(self._samples.size)

    def copy_samples(self, start: int, count: int) -> np.ndarray:
        out = self.copy_samples_raw(start, count)
        if out.dtype == np.int16:
            out = out.astype(np.float32) / 32768.0
        return out

    def copy_samples_raw(self, start: int, count: int) -> np.ndarray:
        out = np.zeros(count, dtype=self._samples.dtype)
        lo = max(0, start)
        hi = min(self._samples.size, start + count)
        if hi > lo:
            out[lo - start : hi - start] = self._samples[lo:hi]
        return out


class DiskBackedAudioSampleSource:
    """mmap view over a raw little-endian f32 (or PCM16) file at 16 kHz.

    With `owns_file=True` the backing temp file is unlinked on close()/GC
    (make_audio_source creates one full-size temp file per long input; a
    batch over many hour-scale files would otherwise fill /tmp)."""

    def __init__(self, path: str | Path, sample_count: int | None = None,
                 *, owns_file: bool = False, dtype: str = "<f4"):
        self._path = Path(path)
        self._mmap = np.memmap(self._path, dtype=dtype, mode="r")
        self._count = int(sample_count if sample_count is not None else self._mmap.size)
        self._finalizer = None
        if owns_file:
            import weakref

            path_str = str(self._path)

            def _cleanup(p=path_str):
                try:
                    os.unlink(p)
                except OSError:
                    pass

            self._finalizer = weakref.finalize(self, _cleanup)

    def close(self) -> None:
        """Release the mmap and delete the backing temp file (if owned)."""
        self._mmap = None
        if self._finalizer is not None:
            self._finalizer()

    @property
    def sample_count(self) -> int:
        return self._count

    def copy_samples(self, start: int, count: int) -> np.ndarray:
        out = self.copy_samples_raw(start, count)
        if out.dtype == np.int16:
            out = out.astype(np.float32) / 32768.0
        return out

    def copy_samples_raw(self, start: int, count: int) -> np.ndarray:
        out = np.zeros(count, dtype=self._mmap.dtype)
        lo = max(0, start)
        hi = min(self._count, start + count)
        if hi > lo:
            out[lo - start : hi - start] = np.asarray(self._mmap[lo:hi])
        return out


def make_audio_source(
    path: str | Path,
    *,
    disk_backed_threshold: int = 480_000,
    converter: AudioConverter | None = None,
) -> AudioSampleSource:
    """File -> source; switches to a mmap temp f32 file above the threshold.

    Threshold default mirrors the reference's `streamingThreshold` (480k samples
    = 30 s @16 kHz, `Parakeet/AsrTypes.swift:5-101`).

    PCM16 mono WAVs and FLACs already at the target rate skip the f32
    conversion entirely: the source stays int16 end-to-end and the device
    upcasts (scale 1/32768) — half the host->device transfer bytes and half
    the temp-file footprint for long files.
    """
    samples: np.ndarray | None = None
    if str(path).lower().endswith((".wav", ".flac")):
        try:
            from fluidaudio_tpu_torch.utils.audio_io import read_audio_raw

            raw, sr = read_audio_raw(path)
            if raw.dtype == np.int16 and raw.shape[1] == 1 and sr == TARGET_SAMPLE_RATE:
                samples = raw[:, 0]
        except (ValueError, OSError, RuntimeError):
            samples = None  # fall through to the converter path
    if samples is None:
        conv = converter or AudioConverter(TARGET_SAMPLE_RATE)
        samples = conv.resample_file(path)
    if samples.size <= disk_backed_threshold:
        return ArrayAudioSource(samples)
    if samples.dtype == np.int16:
        suffix, store = ".i16", samples.astype("<i2")
    else:
        suffix, store = ".f32", samples.astype("<f4")
    tmp = tempfile.NamedTemporaryFile(prefix="fluidaudio_", suffix=suffix, delete=False)
    tmp.write(store.tobytes())
    tmp.close()
    return DiskBackedAudioSampleSource(
        tmp.name, samples.size, owns_file=True, dtype=store.dtype.str
    )
