"""Paraformer of the PyTorch port against the JAX package.

Per module, in f32 at `PARAFORMER_TEST` on the same numpy-seeded inputs:
`cif_integrate` (embeddings <= 1e-5 abs, token counts exact, the count taken
from the same cumulative sum as the weights), the CIF predictor (<= 1e-5
abs), a decoder block and the final FFN-only layer (<= 1e-5 relative L2),
and the whole model on the trained `paraformer` fixture (logits <= 1e-5
relative L2, CIF counts and argmax tokens exact) on random features and on
the fixture utterances' own features. The whole slice: both managers give
identical texts and WER on the held-out utterances of
`eval_paraformer_fixture` and on a 75 s long-form input. The CIF case of
`tests/test_nar_asr.py` runs in `tests/test_torch_sensevoice.py`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidaudio_tpu.asr.paraformer_manager import ParaformerManager as JaxParaformer
from fluidaudio_tpu.models import paraformer as jax_pf
from fluidaudio_tpu.models.sensevoice import lfr_stack as jax_lfr_stack
from fluidaudio_tpu.ops.mel import MelConfig as JaxMelConfig
from fluidaudio_tpu.ops.mel import MelFrontend as JaxMelFrontend
from fluidaudio_tpu.train import fixtures as jax_fx
from fluidaudio_tpu.utils.checkpoint import load_params
from fluidaudio_tpu_torch.asr.paraformer_manager import ParaformerManager
from fluidaudio_tpu_torch.models import paraformer as port_pf
from fluidaudio_tpu_torch.train import fixtures as port_fx
from fluidaudio_tpu_torch.train import tiny_corpus as tc
from fluidaudio_tpu_torch.utils import weights
from tests.test_torch_sensevoice import ATOL, REL_L2, held_out, jitter, rel_l2, to_port
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

CFG = jax_pf.PARAFORMER_TEST


@pytest.mark.parametrize("case", range(6))
def test_cif_integrate_equals_jax(case):
    rs = np.random.RandomState(case)
    B, T, D, U = 3, 37, 8, 16
    h = rs.randn(B, T, D).astype(np.float32)
    alphas = (rs.rand(B, T) * rs.choice([0.3, 0.6, 1.2])).astype(np.float32)
    alphas[:, rs.randint(20, T):] = 0.0
    want_emb, want_n = jax_pf.cif_integrate(jnp.asarray(h), jnp.asarray(alphas), U)
    got_emb, got_n = port_pf.cif_integrate(torch.from_numpy(h), torch.from_numpy(alphas), U)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb), atol=ATOL, rtol=0)


def test_cif_integrate_test_nar_asr_case():
    """`tests/test_nar_asr.py::test_cif_integrate`: 0.5 per frame over 6
    frames fires 3 tokens; token 0 integrates frames 0 and 1."""
    T, D = 6, 4
    h = np.eye(T, D, dtype=np.float32)[None]
    for fn, conv in ((jax_pf.cif_integrate, jnp.asarray), (port_pf.cif_integrate, torch.tensor)):
        emb, counts = fn(conv(h), conv(np.full((1, T), 0.5, np.float32)), max_tokens=4)
        assert int(counts[0]) == 3
        np.testing.assert_allclose(np.asarray(emb[0, 0]), 0.5 * (h[0, 0] + h[0, 1]), atol=1e-6)


def test_cif_predictor_equals_jax():
    rs = np.random.RandomState(3)
    h = rs.randn(2, 21, CFG.d_model).astype(np.float32)
    mask = np.arange(21)[None, :] < np.array([21, 9])[:, None]
    mod = jax_pf.CifPredictor(CFG)
    params = jitter(mod.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(mask)), 4)
    want = np.asarray(mod.apply(params, jnp.asarray(h), jnp.asarray(mask)))
    port = to_port(port_pf.CifPredictor(port_pf.PARAFORMER_TEST), params)
    with torch.no_grad():
        got = port(torch.from_numpy(h), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_decoder_block_and_final_ffn_equal_jax():
    rs = np.random.RandomState(5)
    U, Te, D = CFG.max_tokens, 27, CFG.d_model
    x = rs.randn(2, U, D).astype(np.float32)
    enc = rs.randn(2, Te, D).astype(np.float32)
    tok_mask = np.arange(U)[None, :] < np.array([11, 0])[:, None]  # row 1 fires nothing
    pad_mask = np.arange(Te)[None, :] < np.array([27, 15])[:, None]
    cross = tok_mask[:, None, :, None] & pad_mask[:, None, None, :]
    block = jax_pf._DecoderBlock(CFG)
    args = [jnp.asarray(a) for a in (x, enc, tok_mask, cross)]
    params = jitter(block.init(jax.random.PRNGKey(0), *args), 6)
    want = np.asarray(block.apply(params, *args))
    port = to_port(port_pf.DecoderBlock(port_pf.PARAFORMER_TEST), params)
    ffn = jax_pf._DecoderFfn(CFG)
    fparams = jitter(ffn.init(jax.random.PRNGKey(1), args[0]), 7)
    port_ffn = to_port(port_pf.DecoderFfn(port_pf.PARAFORMER_TEST), fparams)
    with torch.no_grad():
        got = port(*[torch.from_numpy(a) for a in (x, enc, tok_mask, cross)]).numpy()
        got_ffn = port_ffn(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    assert rel_l2(got, want) <= REL_L2
    assert rel_l2(got_ffn, np.asarray(ffn.apply(fparams, args[0]))) <= REL_L2


@functools.cache
def trained_models():
    ckpt = jax_fx.trained_assets_dir() / "paraformer" / "model.npz"
    model = jax_pf.Paraformer(CFG)
    params = load_params(ckpt, model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 560)),
                                          jnp.array([16], jnp.int32)))
    port = port_pf.Paraformer(port_pf.PARAFORMER_TEST)
    weights.load_state(port, weights.load_npz(ckpt))
    return model, params, port.eval()


def check_forward(lfr: np.ndarray, lengths: np.ndarray) -> None:
    model, params, port = trained_models()
    want_logits, want_n = model.apply(params, jnp.asarray(lfr), jnp.asarray(lengths))
    got_logits, got_n = port(torch.from_numpy(lfr), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))  # CIF counts exact
    want_logits = np.asarray(want_logits)
    assert rel_l2(got_logits.numpy(), want_logits) <= REL_L2
    assert (got_logits.numpy().argmax(-1) == want_logits.argmax(-1)).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_trained_forward_equals_jax_on_random_features(seed):
    rs = np.random.RandomState(seed)
    check_forward(rs.randn(2, 45, 560).astype(np.float32), np.array([45, 30], np.int32))


def test_trained_forward_equals_jax_on_fixture_utterances():
    """The JAX frontend's LFR features of the held-out utterances, batched."""
    mel = JaxMelFrontend(JaxMelConfig(n_mels=80, normalize="per_feature"))
    audios = [a for _, a in held_out(654, 6)]
    width = max(a.size for a in audios)
    batch = np.zeros((len(audios), width), np.float32)
    for i, a in enumerate(audios):
        batch[i, : a.size] = a
    m, m_len = mel(jnp.asarray(batch), jnp.asarray([a.size for a in audios], jnp.int32))
    lfr, lfr_len = jax_lfr_stack(m, m_len)
    check_forward(np.array(lfr), np.array(lfr_len))


@functools.cache
def managers():
    ckpt = jax_fx.trained_assets_dir() / "paraformer"
    return (JaxParaformer(CFG, checkpoint_dir=ckpt),
            ParaformerManager(port_pf.PARAFORMER_TEST, checkpoint_dir=ckpt, device="cpu"))


def test_trained_manager_texts_equal_jax():
    jax_mgr, port_mgr = managers()
    for _, audio in held_out(654, 6):
        assert port_mgr.transcribe(audio).text == jax_mgr.transcribe(audio).text
    wer = port_fx.eval_paraformer_fixture(device="cpu")
    assert wer == jax_fx.eval_paraformer_fixture()
    assert wer <= 0.05


def test_long_form_equals_jax():
    jax_mgr, port_mgr = managers()
    rs = np.random.RandomState(11)
    audio = np.concatenate([tc.make_utterance(rs.randint(0, tc.N_WORDS, size=60), rs)
                            for _ in range(3)])[: 75 * 16000]
    got = port_mgr.transcribe(audio).text
    # windows join with "" (as in JAX), so seam words may fuse
    assert got == jax_mgr.transcribe(audio).text and len(got.split()) > 80
