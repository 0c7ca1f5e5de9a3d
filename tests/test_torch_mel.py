"""Log-mel frontend of the PyTorch port against the JAX package.

The port's `MelFrontend` is held against the JAX `MelFrontend(use_fft=False)`
(the windowed-DFT matmul at HIGHEST precision) and the direct numpy golden
`log_mel_numpy`, on a ragged batch with a preemphasis carry, with and without
NeMo `per_feature` normalisation.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fluidaudio_tpu.ops.mel import MelConfig, MelFrontend as JaxMel, log_mel_numpy
from fluidaudio_tpu_torch.ops import mel as port

N = 24160
LENGTHS = np.array([N, 9000, 1600], np.int32)
LAST = np.array([0.1, -0.2, 0.0], np.float32)


def _batch() -> np.ndarray:
    rs = np.random.RandomState(0)
    t = np.arange(N) / 16000
    tone = np.stack([0.5 * np.sin(2 * np.pi * 440 * t), 0.3 * np.sin(2 * np.pi * 1234 * t),
                     0.2 * np.sin(2 * np.pi * 3000 * t)])
    audio = tone + 0.01 * rs.randn(3, N)
    audio[1, 4000:6000] = 1e-4 * rs.randn(2000)  # near-silence stretch
    return audio.astype(np.float32)


@pytest.fixture(scope="module")
def audio():
    return _batch()


def _port(cfg, audio):
    mel, lens = port.MelFrontend(cfg, device="cpu")(
        torch.from_numpy(audio), torch.from_numpy(LENGTHS), torch.from_numpy(LAST))
    return mel.numpy(), lens.numpy()


@pytest.mark.parametrize("normalize", [None, "per_feature"])
def test_matches_jax_frontend(audio, normalize):
    """Both sides accumulate the DFT in true f32; they differ only in summation
    order. 2e-3 on log-mel values of order 1-20 is ~10x the largest
    difference observed, near-silence bins included."""
    cfg = MelConfig(normalize=normalize)
    want, want_len = JaxMel(cfg, use_fft=False)(
        jnp.asarray(audio), jnp.asarray(LENGTHS), jnp.asarray(LAST))
    got, got_len = _port(cfg, audio)
    np.testing.assert_array_equal(got_len, np.asarray(want_len))
    assert got.shape == (3, cfg.n_mels, cfg.num_frames(N)) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-3, rtol=0)


@pytest.mark.parametrize("normalize", [None, "per_feature"])
def test_matches_numpy_golden_per_row(audio, normalize):
    """Each ragged row equals the golden run on that row's samples alone, and
    frames past the row's length are zero."""
    cfg = MelConfig(normalize=normalize)
    got, got_len = _port(cfg, audio)
    for b, n in enumerate(LENGTHS):
        golden = log_mel_numpy(audio[b, :n], cfg, last_sample=float(LAST[b]))
        frames = golden.shape[1]
        assert got_len[b] == frames
        if normalize is None:
            # f32 against f64 golden: compare where there is signal (the
            # near-silence log floor is cancellation-dominated in any f32 DFT)
            sig = golden > -12.0
            np.testing.assert_allclose(got[b, :, :frames][sig], golden[sig], atol=2e-3, rtol=0)
        else:
            np.testing.assert_allclose(got[b, :, :frames], golden, atol=2e-3, rtol=0)
        assert not got[b, :, frames:].any()


def test_per_feature_uses_ddof1_over_valid_frames_only(audio):
    """Valid frames of every row come out with zero mean and unit (ddof=1)
    standard deviation per mel bin, whatever padding follows them."""
    got, got_len = _port(MelConfig(normalize="per_feature"), audio)
    for b, n in enumerate(got_len):
        valid = got[b, :, :n].astype(np.float64)
        np.testing.assert_allclose(valid.mean(axis=1), 0.0, atol=1e-4)
        std = valid.std(axis=1, ddof=1)
        assert np.all(std < 1.0 + 1e-3) and np.median(std) > 0.99


def test_single_valid_frame_clamps_n_to_two():
    """One valid frame: mean over n=max(1,2) frames as in the JAX frontend,
    so the output is finite (ddof=1 would divide by zero)."""
    cfg = MelConfig(normalize="per_feature")
    x = np.random.RandomState(3).randn(1, 800).astype(np.float32) * 0.1
    lens = np.array([100], np.int32)  # 100 // 160 + 1 = 1 frame
    want, _ = JaxMel(cfg, use_fft=False)(jnp.asarray(x), jnp.asarray(lens))
    got, got_len = port.MelFrontend(cfg, device="cpu")(torch.from_numpy(x),
                                                       torch.from_numpy(lens))
    assert int(got_len[0]) == 1
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=0)


def test_int_lengths_default_to_full_rows_and_1d_input():
    cfg = MelConfig()
    x = np.random.RandomState(4).randn(4000).astype(np.float32) * 0.1
    got, got_len = port.MelFrontend(cfg, device="cpu")(torch.from_numpy(x))
    assert got.shape == (1, 128, cfg.num_frames(4000))
    assert int(got_len[0]) == cfg.num_frames(4000)
