"""`CtcKeywordSpotter` of the PyTorch port against the JAX spotter.

On the trained `ctc` fixture (encoder d 64, 2 layers, Dh 16, f32; the CTC
head `[64, 17]`, blank last), both spotters build the whole-recording
canvas of a 17 s utterance (two 15 s chunks and the edge-aware seam merge):
fed the same mel, within 1e-4 of each other; each on its own mel frontend
within 1e-3 (the frontends' f32 DFTs differ in near-silent bins), and
`spot` returns identical spots. The port's
fixture evaluations (`fluidaudio_tpu_torch/train/fixtures.py`) equal the
JAX package's on the same seeds, and clear its gates. The merge and dedupe
cases of `tests/test_keyword_spotter.py` run against the port
(`jax_cases`). The fixture's npz files load through `utils/weights.py`
(`ctc_head.npz` keeps its `head` key and layout).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidaudio_tpu.train import fixtures as jax_fx
from fluidaudio_tpu_torch.asr import keyword_spotter as port_kws
from fluidaudio_tpu_torch.train import fixtures as port_fx
from fluidaudio_tpu_torch.train import tiny_corpus as tc
from fluidaudio_tpu_torch.utils.weights import load_npz
from tests.test_torch_custom_vocab import jax_cases, one_torch_thread  # noqa: F401

TERMS = ["w0 w3", "w5", "w1 w2 w6", "w4 w7", "w11"]


def spotting_audio():
    """17 s: background words with the terms planted, as the JAX spotting
    evaluation builds it (another seed)."""
    rs = np.random.RandomState(2024)
    seq = list(rs.randint(8, tc.N_WORDS, size=34))
    for pos, ids in ((3, [0, 3]), (17, [5]), (30, [1, 2, 6])):
        seq[pos:pos] = ids
    return tc.make_utterance(np.asarray(seq), rs)


@pytest.fixture(scope="module")
def spotters():
    jax_spotter, _ = jax_fx._ctc_spotter(TERMS)
    port_spotter, _ = port_fx._ctc_spotter(TERMS, device="cpu")
    return jax_spotter, port_spotter


class JaxMel:
    """The JAX spotter's mel frontend behind the port's call signature."""

    def __init__(self, jax_spotter, cfg):
        self.jax_mel, self.cfg = jax_spotter.mel, cfg

    def __call__(self, audio, lengths):
        mel, mel_len = self.jax_mel(jnp.asarray(audio.numpy()), jnp.asarray(lengths.numpy()))
        return torch.from_numpy(np.array(mel)), torch.from_numpy(np.array(mel_len))


def canvases(jax_spotter, port_spotter, audio, shared_mel: bool):
    want = jax_spotter.log_probs(audio)
    own_mel = port_spotter.mel
    if shared_mel:
        port_spotter.mel = JaxMel(jax_spotter, own_mel.cfg)
    try:
        got = port_spotter.log_probs(audio)
    finally:
        port_spotter.mel = own_mel
    assert got.dtype == np.float32 and got.shape == want.shape
    return got, want


def test_canvas_on_the_same_mel_within_1e4_of_jax(spotters):
    """Chunking, encoder, head, log-softmax and the seam merge, fed JAX's
    own mel: within 1e-4 of JAX's canvas."""
    got, want = canvases(*spotters, spotting_audio(), shared_mel=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_canvas_and_spots_equal_jax(spotters):
    """End to end on each package's own mel frontend. The frontends differ
    by up to ~4e-3 on this corpus's near-silent bins (against a float64
    DFT, JAX's Cooley-Tukey f32 DFT is off by 3.8e-3 and the port's direct
    f32 DFT by 5.4e-4), which moves the canvas by up to ~3e-4: 1e-3 here,
    and the same spots."""
    jax_spotter, port_spotter = spotters
    audio = spotting_audio()
    assert audio.size > port_kws.CHUNK_SAMPLES  # two chunks and a seam
    got, want = canvases(jax_spotter, port_spotter, audio, shared_mel=False)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    want_spots = [vars(s) for s in jax_spotter.spot(audio)]
    got_spots = [vars(s) for s in port_spotter.spot(audio)]
    assert [s["keyword"] for s in got_spots] == [s["keyword"] for s in want_spots]
    for g, w in zip(got_spots, want_spots):
        assert (g["start_frame"], g["end_frame"]) == (w["start_frame"], w["end_frame"])
        assert g["score"] == pytest.approx(w["score"], abs=1e-3)
    assert {"w0 w3", "w5", "w1 w2 w6"} <= {s["keyword"] for s in got_spots}


@pytest.mark.parametrize("n_samples", [3_000, 100_000, 240_000, 250_000, 460_000])
def test_canvas_frames_per_length_equal_jax(spotters, n_samples):
    """Short tails, one exact chunk, a tail under 4,000 samples past a chunk
    (dropped) and three chunks: the same canvas length, and on the same mel
    the same values within 1e-4."""
    audio = (np.random.RandomState(n_samples).randn(n_samples) * 0.05).astype(np.float32)
    got, want = canvases(*spotters, audio, shared_mel=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["eval_ctc_fixture", "eval_ctc_spotting_fixture",
                                  "eval_vocab_boost_fixture"])
def test_fixture_evaluations_equal_jax(name):
    want = getattr(jax_fx, name)()
    got = getattr(port_fx, name)(device="cpu")
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-9)
    if name == "eval_ctc_fixture":
        assert got["wer_avg"] <= port_fx.ASR_WER_GATE and got["beam_agree_rate"] == 1.0
    elif name == "eval_ctc_spotting_fixture":
        assert got["recall"] >= port_fx.KWS_RECALL_GATE
        assert got["precision"] >= port_fx.KWS_PRECISION_GATE
    else:
        assert got["corrected"] == 1.0 and got["false_boost"] == 0.0


def test_fixture_constants_equal_jax():
    assert port_fx.CTC_BLANK_ID == jax_fx.CTC_BLANK_ID
    assert (port_fx.KWS_RECALL_GATE, port_fx.KWS_PRECISION_GATE, port_fx.ASR_WER_GATE) == (
        jax_fx.KWS_RECALL_GATE, jax_fx.KWS_PRECISION_GATE, jax_fx.ASR_WER_GATE)
    assert port_fx.trained_assets_dir() == jax_fx.trained_assets_dir()
    jax_cfg, port_cfg = jax_fx.ctc_tiny_enc_cfg(), port_fx.ctc_tiny_enc_cfg()
    for field in ("d_model", "n_layers", "n_heads", "subsampling_channels", "dtype"):
        assert getattr(port_cfg, field) == getattr(jax_cfg, field)
    assert port_cfg.head_dim == 16
    assert (port_kws.CHUNK_SAMPLES, port_kws.CHUNK_STRIDE, port_kws.SEAM_EDGE_FRAMES) == (
        240_000, 207_360, 4)


def test_fixture_weights_load_through_the_npz_loader(spotters):
    _, port_spotter = spotters
    ckpt = port_fx.trained_assets_dir() / "ctc"
    head = load_npz(ckpt / "ctc_head.npz")
    assert list(head) == ["head"] and head["head"].shape == (64, tc.N_WORDS + 1)
    torch.testing.assert_close(port_spotter.ctc_head, torch.from_numpy(head["head"]))
    state = load_npz(ckpt / "encoder.npz")
    assert set(state) == set(port_spotter.encoder.state_dict())


def test_missing_checkpoint_is_seeded_random(tmp_path):
    from fluidaudio_tpu_torch.asr.custom_vocab.context import CustomVocabularyContext

    make = lambda: port_kws.CtcKeywordSpotter(
        CustomVocabularyContext([]), port_kws.KeywordSpotterConfig(vocab_size=16),
        port_fx.ctc_tiny_enc_cfg(), checkpoint_dir=tmp_path, device="cpu")
    a, b = make(), make()
    torch.testing.assert_close(a.ctc_head, b.ctc_head, rtol=0, atol=0)
    assert float(a.ctc_head.detach().std()) == pytest.approx(0.02, rel=0.2)


CASES = jax_cases("test_keyword_spotter.py",
                  select=("TestMergeOverlapFrames", "test_dedupe", "test_spot_merges"))


@pytest.mark.parametrize("case", CASES)
def test_jax_keyword_spotter_case_on_the_port(case):
    case()
