"""WAV/FLAC read and WAV write without external audio deps.

Behavioral parity: reference `Shared/AudioConverter.swift:458-517` (`AudioWAV.data`
writer) and the AVAudioFile read paths (which handle wav AND flac through the
OS decoder). Supports PCM 8/16/24/32-bit int and 32/64-bit float WAV, mono or
multichannel; FLAC decodes via the native library (`native/flac.py`, built
from `native/flac/flac.cpp`).
Float reads return float32 in [-1, 1]; `read_audio_raw` preserves int16 for
the half-bytes device-transfer path.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (samples float32 [n, channels], sample_rate)."""
    x, sample_rate = read_wav_raw(path)
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 32768.0
    return x, sample_rate


def read_audio_raw(path: str | Path) -> tuple[np.ndarray, int]:
    """Dtype-preserving reader for WAV and FLAC (dispatch by magic bytes).

    PCM16 WAV and FLAC return int16 [n, channels] (FLAC sources wider than
    16 bits round down); other WAV formats return float32 in [-1, 1].
    """
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        from fluidaudio_tpu_torch.native.flac import read_flac_raw

        return read_flac_raw(path)
    return read_wav_raw(path)


def read_audio(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a WAV or FLAC file -> (samples float32 [n, channels], rate)."""
    x, sample_rate = read_audio_raw(path)
    if x.dtype == np.int16:
        x = x.astype(np.float32) / 32768.0
    return x, sample_rate


def read_wav_raw(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a WAV file dtype-preservingly for PCM16.

    PCM16 payloads come back as int16 [n, channels] (half the memory and —
    when shipped to the device raw — half the host->device transfer bytes;
    scale 1/32768 applied on-device). Every other format returns float32 in
    [-1, 1] exactly like `read_wav`.
    """
    data = Path(path).read_bytes()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")

    fmt = None
    payload = None
    pos = 12
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = body
        elif chunk_id == b"data":
            payload = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or payload is None:
        raise ValueError(f"missing fmt/data chunk: {path}")
    audio_format, channels, sample_rate, bits = _parse_fmt_body(fmt)
    x = _decode_payload(payload, audio_format, bits)

    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels)
    else:
        x = x.reshape(-1, 1)
    return x, sample_rate


def _parse_fmt_body(body: bytes) -> tuple[int, int, int, int]:
    """fmt chunk body -> (audio_format, channels, sample_rate, bits).

    WAVE_FORMAT_EXTENSIBLE (0xFFFE) resolves to the real tag carried in the
    first two bytes of the SubFormat GUID (fmt body offset 24)."""
    audio_format, channels, sample_rate, _, _, bits = struct.unpack_from(
        "<HHIIHH", body, 0
    )
    if audio_format == 0xFFFE and len(body) >= 26:
        (audio_format,) = struct.unpack_from("<H", body, 24)
    return audio_format, channels, sample_rate, bits


def _bytes_per_sample(audio_format: int, bits: int) -> int:
    if audio_format == 1 and bits in (8, 16, 24, 32):
        return bits // 8
    if audio_format == 3 and bits in (32, 64):
        return bits // 8
    raise ValueError(f"unsupported WAV format tag/bits: {audio_format}/{bits}")


def _decode_payload(payload: bytes, audio_format: int, bits: int) -> np.ndarray:
    """Raw interleaved payload bytes -> flat samples.

    PCM16 stays int16 (half-bytes device-transfer contract); everything else
    becomes float32 in [-1, 1]."""
    if audio_format == 1:  # PCM int
        if bits == 16:
            return np.frombuffer(payload, dtype="<i2").astype(np.int16)
        if bits == 32:
            return np.frombuffer(payload, dtype="<i4").astype(np.float32) / 2147483648.0
        if bits == 8:
            return (np.frombuffer(payload, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        if bits == 24:
            raw = np.frombuffer(payload, dtype=np.uint8).reshape(-1, 3)
            vals = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            return vals.astype(np.float32) / float(1 << 23)
        raise ValueError(f"unsupported PCM bit depth: {bits}")
    if audio_format == 3:  # IEEE float
        if bits == 32:
            return np.frombuffer(payload, dtype="<f4").astype(np.float32)
        if bits == 64:
            return np.frombuffer(payload, dtype="<f8").astype(np.float32)
        raise ValueError(f"unsupported float bit depth: {bits}")
    raise ValueError(f"unsupported WAV format tag: {audio_format}")


class WavStreamReader:
    """Random-access WAV frame reader with O(chunk) memory.

    The whole-file readers above materialize the full payload; this reader
    scans only the chunk headers (seeking over bodies) and decodes frame
    ranges on demand — the constant-memory producer behind
    `AudioConverter.stream_convert_to_file`, matching the reference's
    streaming convert (`Shared/AudioConverter.swift:372`,
    `AudioSourceFactory.swift:12-60`) where hour-long files never
    materialize in RAM.

    Use as a context manager; `read_frames(start, count)` returns
    [n, channels] (int16 for PCM16, float32 otherwise — same dtype contract
    as `read_wav_raw`).
    """

    def __init__(self, path: str | Path):
        self._f = open(path, "rb")
        try:
            head = self._f.read(12)
            if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
                raise ValueError(f"not a RIFF/WAVE file: {path}")
            fmt = None
            self._data_offset = None
            data_size = 0
            while True:
                hdr = self._f.read(8)
                if len(hdr) < 8:
                    break
                chunk_id = hdr[:4]
                (size,) = struct.unpack_from("<I", hdr, 4)
                if chunk_id == b"fmt ":
                    fmt = self._f.read(size)
                    if size & 1:
                        self._f.seek(1, 1)
                elif chunk_id == b"data":
                    self._data_offset = self._f.tell()
                    data_size = size
                    self._f.seek(size + (size & 1), 1)
                else:
                    self._f.seek(size + (size & 1), 1)
            if fmt is None or self._data_offset is None:
                raise ValueError(f"missing fmt/data chunk: {path}")
            self.audio_format, self.channels, self.sample_rate, self.bits = (
                _parse_fmt_body(fmt)
            )
            bps = _bytes_per_sample(self.audio_format, self.bits)
            self._frame_bytes = bps * self.channels
            # tolerate a data-chunk size field that overruns the actual file
            # (truncated writes): clamp to what is really present
            end = self._f.seek(0, 2)
            avail = max(0, end - self._data_offset)
            self.n_frames = min(data_size, avail) // self._frame_bytes
        except Exception:
            self._f.close()
            raise

    def read_frames(self, start: int, count: int) -> np.ndarray:
        start = max(0, min(int(start), self.n_frames))
        count = max(0, min(int(count), self.n_frames - start))
        self._f.seek(self._data_offset + start * self._frame_bytes)
        payload = self._f.read(count * self._frame_bytes)
        x = _decode_payload(payload, self.audio_format, self.bits)
        return x.reshape(-1, self.channels)

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "WavStreamReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_wav(
    path: str | Path,
    samples: np.ndarray,
    sample_rate: int,
    *,
    dtype: str = "int16",
) -> None:
    """Write samples [n] or [n, channels] as a PCM16 or float32 WAV.

    int16 input with dtype="int16" is written verbatim (no scale/clip), so a
    PCM16 payload round-trips bit-exactly through write_wav -> read_wav_raw.
    Float input is clipped and scaled by 32767 as before.
    """
    x = np.asarray(samples)
    if x.dtype == np.int16:
        if dtype != "int16":
            x = x.astype(np.float32) / 32768.0
    else:
        x = x.astype(np.float32)
    if x.ndim == 1:
        x = x[:, None]
    channels = x.shape[1]

    if dtype == "int16":
        if x.dtype == np.int16:
            body = x.astype("<i2").tobytes()
        else:
            body = (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        audio_format, bits = 1, 16
    elif dtype == "float32":
        body = x.astype("<f4").tobytes()
        audio_format, bits = 3, 32
    else:
        raise ValueError(f"unsupported dtype: {dtype}")

    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    header = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    header += b"fmt " + struct.pack(
        "<IHHIIHH", 16, audio_format, channels, sample_rate, byte_rate, block_align, bits
    )
    header += b"data" + struct.pack("<I", len(body))
    Path(path).write_bytes(header + body)
