"""SenseVoice of the PyTorch port against the JAX package.

Per module, the same numpy-seeded inputs and parameters go through the JAX
function and the port's, in f32 at `SENSEVOICE_TEST`: `lfr_stack` (exact),
a SANM block with and without its attention residual (<= 1e-5 relative
L2: the two libraries sum a 560-wide product in different orders; padded
rows included: JAX fills the mask with finfo.min, so a fully masked query
row comes out uniform, never NaN), and the whole encoder on the trained
`sensevoice` fixture (<= 1e-5 relative L2). The whole slice: the trained
fixture through both managers gives identical texts, token timings and WER
on the held-out utterances of `eval_sensevoice_fixture`, and on a 75 s
long-form input. The cases of `tests/test_nar_asr.py` run against the port
(`jax_cases`, with `jnp` standing for torch).
"""

from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidaudio_tpu.asr.sensevoice_manager import SenseVoiceManager as JaxSenseVoice
from fluidaudio_tpu.models import sensevoice as jax_sv
from fluidaudio_tpu.train import fixtures as jax_fx
from fluidaudio_tpu.utils.checkpoint import load_params
from fluidaudio_tpu_torch.asr.sensevoice_manager import SenseVoiceManager
from fluidaudio_tpu_torch.models import sensevoice as port_sv
from fluidaudio_tpu_torch.train import fixtures as port_fx
from fluidaudio_tpu_torch.train import tiny_corpus as tc
from fluidaudio_tpu_torch.utils import weights
from tests.test_torch_custom_vocab import jax_cases, one_torch_thread  # noqa: F401

ATOL = 1e-5  # elementwise outputs (positions), f32
REL_L2 = 1e-5  # block and encoder outputs (560-wide f32 contractions), f32


def jitter(params, seed: int, scale: float = 0.1):
    """Every leaf of a flax tree plus seeded noise (LayerNorm scales and
    biases included), as numpy."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rs.randn(*np.shape(a)) * scale).astype(np.float32), params)


def to_port(module: torch.nn.Module, params) -> torch.nn.Module:
    weights.load_state(module, weights.from_jax_params(jax.tree.map(np.asarray, params)))
    return module.eval()


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("T,lengths", [(20, [20, 13]), (7, [1, 7]), (61, [61, 30]), (6, [6, 0])])
def test_lfr_stack_equals_jax(T, lengths):
    mel = np.random.RandomState(T).randn(2, 80, T).astype(np.float32)
    want, want_len = jax_sv.lfr_stack(jnp.asarray(mel), jnp.asarray(lengths, jnp.int32))
    got, got_len = port_sv.lfr_stack(torch.from_numpy(mel), torch.tensor(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_len.dtype == torch.int32


@pytest.mark.parametrize("in_size", [560, 64], ids=["block0-no-residual", "residual"])
def test_sanm_block_equals_jax(in_size):
    cfg = jax_sv.SENSEVOICE_TEST
    rs = np.random.RandomState(in_size)
    x = rs.randn(2, 19, in_size).astype(np.float32)
    lengths = np.array([19, 11])
    mask = np.arange(19)[None, :] < lengths[:, None]
    block = jax_sv._SanmBlock(cfg, in_size=in_size)
    params = jitter(block.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask)), 1)
    want = np.asarray(block.apply(params, jnp.asarray(x), jnp.asarray(mask)))
    port = to_port(port_sv.SanmBlock(port_sv.SENSEVOICE_TEST, in_size), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()  # padded query rows: uniform, not NaN
    assert rel_l2(got, want) <= REL_L2, rel_l2(got, want)


def test_sinusoid_posenc_equals_jax():
    """1e-4: the angles reach 300 rad, which turns the two libraries' one-ulp
    f32 `exp` differences into ~3e-5 on the sines."""
    want = np.asarray(jax_sv._sinusoid_posenc(300, 560))
    got = port_sv.sinusoid_posenc(300, 560).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[:40], want[:40], atol=ATOL, rtol=0)


@functools.cache
def trained_encoders():
    ckpt = jax_fx.trained_assets_dir() / "sensevoice" / "encoder.npz"
    enc = jax_sv.SenseVoiceEncoder(jax_sv.SENSEVOICE_TEST)
    lfr0 = jnp.zeros((1, 16, 560), jnp.float32)
    params = load_params(ckpt, enc.init(jax.random.PRNGKey(0), lfr0, jnp.array([16]),
                                        jnp.zeros((1,), jnp.int32)))
    port = port_sv.SenseVoiceEncoder(port_sv.SENSEVOICE_TEST)
    weights.load_state(port, weights.load_npz(ckpt))
    return enc, params, port.eval()


@pytest.mark.parametrize("lang", [0, 2, 5])
def test_trained_encoder_equals_jax(lang):
    enc, params, port = trained_encoders()
    rs = np.random.RandomState(lang)
    lfr = rs.randn(2, 40, 560).astype(np.float32)
    lengths = np.array([40, 23], np.int32)
    langs = np.array([lang, 0], np.int32)
    want = np.asarray(enc.apply(params, jnp.asarray(lfr), jnp.asarray(lengths),
                                jnp.asarray(langs)))
    got = port(torch.from_numpy(lfr), torch.from_numpy(lengths), torch.from_numpy(langs))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel_l2(got.numpy(), want) <= REL_L2
    assert (got.numpy().argmax(-1) == want.argmax(-1)).all()


@functools.cache
def managers():
    ckpt = jax_fx.trained_assets_dir() / "sensevoice"
    return (JaxSenseVoice(jax_sv.SENSEVOICE_TEST, checkpoint_dir=ckpt),
            SenseVoiceManager(port_sv.SENSEVOICE_TEST, checkpoint_dir=ckpt, device="cpu"))


def held_out(seed: int, n_utts: int, max_words: int = 9):
    """The utterances of the fixture evaluation: (transcript, audio)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n_utts):
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, max_words)))
        out.append((tc.transcript_text(ids), tc.make_utterance(ids, rs)))
    return out


def test_trained_manager_texts_and_timings_equal_jax():
    jax_mgr, port_mgr = managers()
    for truth, audio in held_out(321, 6):
        want, got = jax_mgr.transcribe(audio), port_mgr.transcribe(audio)
        assert got.text == want.text
        assert [(t.token_id, t.start_time, t.end_time) for t in got.token_timings] == \
            [(t.token_id, t.start_time, t.end_time) for t in want.token_timings]
    wer = port_fx.eval_sensevoice_fixture(device="cpu")
    assert wer == jax_fx.eval_sensevoice_fixture()
    assert wer <= 0.05


def test_long_form_equals_jax():
    """75 s: two full 30 s windows and a 15 s tail."""
    jax_mgr, port_mgr = managers()
    rs = np.random.RandomState(9)
    audio = np.concatenate([tc.make_utterance(rs.randint(0, tc.N_WORDS, size=60), rs)
                            for _ in range(3)])[: 75 * 16000]
    want, got = jax_mgr.transcribe(audio, language="en"), port_mgr.transcribe(audio,
                                                                              language="en")
    assert got.text == want.text and len(got.text.split()) > 100
    assert [(t.token_id, t.start_time) for t in got.token_timings] == \
        [(t.token_id, t.start_time) for t in want.token_timings]


# `jnp` in the JAX test module stands for torch here
_TORCH_JNP = types.SimpleNamespace(
    asarray=torch.as_tensor, array=lambda x, dtype=None: torch.tensor(x, dtype=dtype),
    full=lambda shape, value: torch.full(shape, value, dtype=torch.float32),
    int32=torch.int32,
)
CASES = jax_cases("test_nar_asr.py", overrides={"jnp": _TORCH_JNP}, edits=[
    ("SenseVoiceManager(SENSEVOICE_TEST)", 'SenseVoiceManager(SENSEVOICE_TEST, device="cpu")'),
    ("ParaformerManager(PARAFORMER_TEST)", 'ParaformerManager(PARAFORMER_TEST, device="cpu")'),
], fixtures=True)


@pytest.mark.parametrize("case", CASES)
def test_jax_nar_asr_case_on_the_port(case, request):
    case(request)
