"""FLAC input of the PyTorch port against the JAX package's decoder.

Both decode bytes from the pure-Python encoder of `tests/test_flac.py`
(constant / verbatim / fixed-order subframes, rice residuals, stereo
decorrelation, 24-bit sources): the port's `decode_flac`, whose library it
builds from `native/flac/flac.cpp` with the host C++ compiler, must return
the encoded PCM exactly and the same array, rate and error messages as the
JAX binding, which runs over the port's library put into the JAX loader's
slot (`jax_native_on_the_port_build`), so that no cmake build starts. A
`.flac` read through the port's `audio_io` must equal the same audio as WAV.
"""

import numpy as np
import pytest

from fluidaudio_tpu.native import flac as jax_flac
from fluidaudio_tpu_torch.native import flac as port_flac
from fluidaudio_tpu_torch.utils import audio_io
from tests.test_torch_custom_vocab import jax_module
from tests.test_torch_custom_vocab import jax_native_on_the_port_build, one_torch_thread  # noqa: F401

# the pure-Python encoder of tests/test_flac.py, loaded with its decoder
# imports pointed at the port's binding, so that its module-level
# `native_available()` builds the port's library and never starts the JAX
# loader's cmake build
_TEST_FLAC = jax_module("test_flac.py", ("native.flac",))
_pcm16, encode_flac = _TEST_FLAC._pcm16, _TEST_FLAC.encode_flac


def _smooth(n=1500):
    t = np.arange(n, dtype=np.float64)
    return (3000 * np.sin(t * 0.02) + 500 * np.sin(t * 0.11)).astype(np.int16)


def _stereo():
    pcm = _pcm16(2, 600, ch=2)
    pcm[:, 1] = (pcm[:, 0] * 0.7).astype(np.int16)  # correlated channels
    return pcm


PCM24 = np.random.RandomState(3).randint(-(1 << 23), 1 << 23, size=400, dtype=np.int64)
# (name, pcm, encoder options, expected int16 [n, ch])
CASES = [
    ("verbatim_mono", _pcm16(0, 1000), {}, None),
    ("partial_block", _pcm16(1, 777), {}, None),
    ("no_streaminfo_total", _pcm16(1, 777), {"total_in_streaminfo": False}, None),
    ("constant", np.full(512, -12345, np.int16), {"subframe": "constant"}, None),
    *((f"fixed{o}", _smooth(), {"subframe": f"fixed{o}"}, None) for o in range(5)),
    *((f"stereo_{s}", _stereo(), {"stereo": s}, None)
      for s in ("independent", "left-side", "mid-side")),
    ("24bit_rounds_down", PCM24, {"bps": 24}, (PCM24 >> 8).astype(np.int16)),
    ("8khz", _pcm16(7, 800), {"sample_rate": 8000}, None),
]


def _jax_decoder():
    """The JAX binding's decoder (over the port's library), or None where it
    reports no library."""
    return jax_flac.decode_flac if jax_flac.native_available() else None


@pytest.mark.parametrize("name,pcm,opts,expected", CASES, ids=[c[0] for c in CASES])
def test_decode_matches_pcm_and_jax(name, pcm, opts, expected):
    data = encode_flac(pcm, **opts)
    got, rate = port_flac.decode_flac(data)
    want = expected if expected is not None else pcm
    want = want.reshape(want.shape[0], -1)
    assert got.dtype == np.int16 and rate == opts.get("sample_rate", 16_000)
    np.testing.assert_array_equal(got, want)
    if _jax_decoder() is not None:
        jax_out, jax_rate = _jax_decoder()(data)
        assert jax_rate == rate
        np.testing.assert_array_equal(got, jax_out)


@pytest.mark.parametrize("data", [
    b"RIFFxxxxWAVE" + b"\x00" * 64,  # not a FLAC stream (code 1)
    b"fLaC",  # no STREAMINFO
    encode_flac(_pcm16(4, 300))[:60],  # truncated inside the first frame
    encode_flac(_pcm16(4, 300))[:200],
], ids=["not_flac", "magic_only", "truncated_early", "truncated_mid_frame"])
def test_error_codes_match_jax(data):
    assert port_flac._ERRORS == jax_flac._ERRORS
    with pytest.raises(port_flac.FlacError, match="FLAC decode failed: ") as got:
        port_flac.decode_flac(data)
    assert isinstance(got.value, ValueError)
    assert str(got.value).split(": ", 1)[1] in port_flac._ERRORS.values()
    if _jax_decoder() is not None:
        with pytest.raises(jax_flac.FlacError) as want:
            _jax_decoder()(data)
        assert str(got.value) == str(want.value)


def test_read_audio_flac_equals_wav(tmp_path):
    pcm = _pcm16(8, 24_000)
    flac_path, wav_path = tmp_path / "d.flac", tmp_path / "d.wav"
    flac_path.write_bytes(encode_flac(pcm))
    audio_io.write_wav(wav_path, pcm, 16_000, dtype="int16")
    raw, rate = audio_io.read_audio_raw(flac_path)
    assert rate == 16_000 and raw.dtype == np.int16
    np.testing.assert_array_equal(raw, audio_io.read_audio_raw(wav_path)[0])
    f32, _ = audio_io.read_audio(flac_path)
    np.testing.assert_array_equal(f32, audio_io.read_audio(wav_path)[0])
    assert f32.dtype == np.float32


def test_build_is_keyed_and_a_failed_build_raises(tmp_path, monkeypatch):
    lib, _ = port_flac.build_library()
    assert lib == port_flac.library_path() and lib.exists()
    assert lib.parent.name == "_build" and lib.name.startswith("libflac_")
    # a compiler that fails: the build raises and leaves no library behind
    monkeypatch.setattr(port_flac, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="FLAC decoder build failed"):
        port_flac.build_library()
    assert not list(tmp_path.iterdir())


def test_chip_smoke_flac_writer():
    """`chip_smoke.flac_bytes` (the writer the card run feeds through
    `audio_io`, since the card machine has no JAX) makes streams both
    decoders read back exactly, past 128 frames (2-byte frame numbers)."""
    from chip_smoke import flac_bytes

    pcm = (np.random.RandomState(1).randn(4096 * 130 + 77) * 3000).astype(np.int16)
    data = flac_bytes(pcm)
    got, rate = port_flac.decode_flac(data)
    assert rate == 16_000
    np.testing.assert_array_equal(got[:, 0], pcm)
    if _jax_decoder() is not None:
        np.testing.assert_array_equal(_jax_decoder()(data)[0], got)
