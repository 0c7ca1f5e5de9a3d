"""Supertonic-3 of the PyTorch port against the JAX package.

On JAX's seeded init (flax's zero-initialised `mod` and estimator
`out_proj` kernels perturbed, so the estimator is not the identity), f32,
SUPERTONIC3_TEST, loaded through `utils/weights.py`:
- the text encoder and the duration predictor on a ragged batch (unknown
  ids -1 included), one estimator step on ragged latent and text masks, the
  vocoder: REL_L2;
- `Supertonic3Manager` from a saved checkpoint directory: the host latent
  draw bit-equal (numpy `RandomState`, as in JAX), the latent after the
  8-step denoise loop and the audio within REL_L2_AUDIO, equal durations
  and lengths.

The cases of `tests/test_tts_backends.py` (StyleTTS2 and Supertonic) and
`tests/test_supertonic_text.py` run on the port (`jax_cases`);
`test_supertonic_estimator_feedback_contract` drives the flax
`apply` protocol, and its port counterpart is
`test_estimator_feeds_back_as_in_jax` here.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidaudio_tpu.models import supertonic3 as js3
from fluidaudio_tpu.tts import supertonic_manager as jax_mgr
from fluidaudio_tpu.utils.checkpoint import save_params
from fluidaudio_tpu_torch.models import supertonic3 as ps3
from fluidaudio_tpu_torch.tts import supertonic_manager as port_mgr
from fluidaudio_tpu_torch.utils.weights import from_jax_params, load_state
from tests.test_torch_custom_vocab import jax_cases, jax_fixtures, one_torch_thread  # noqa: F401

REL_L2 = 1e-5
REL_L2_AUDIO = 1e-4
CFG_J, CFG_P = js3.SUPERTONIC3_TEST, ps3.SUPERTONIC3_TEST


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(x):
    return torch.as_tensor(np.array(x))


def _perturbed(params, seed: int):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.array(a) + rs.randn(*np.shape(a)).astype(np.float32) * 0.05, params)


def _load(module, params):
    load_state(module, from_jax_params(params))
    return module.eval()


def test_config_fields_are_jax_s():
    assert [f.name for f in dataclasses.fields(ps3.Supertonic3Config)] == [
        f.name for f in dataclasses.fields(js3.Supertonic3Config)]
    assert dataclasses.asdict(ps3.SUPERTONIC3_BASE) == dataclasses.asdict(js3.SUPERTONIC3_BASE)


def _text_inputs():
    rs = np.random.RandomState(0)
    T = CFG_J.text_t
    ids = rs.randint(0, CFG_J.vocab_size, (2, T)).astype(np.int32)
    ids[0, 3] = ids[1, 7] = -1  # unknown scalars
    mask = np.zeros((2, T), np.float32)
    mask[0, :20], mask[1, :9] = 1.0, 1.0
    ttl = rs.randn(2, 50, 256).astype(np.float32) * 0.1
    dp = rs.randn(2, 8, 16).astype(np.float32) * 0.1
    return ids, mask, ttl, dp


def test_text_encoder_and_duration_predictor_equal_jax():
    ids, mask, ttl, dp = _text_inputs()
    for cls_j, cls_p, style in ((js3.Supertonic3TextEncoder, ps3.Supertonic3TextEncoder, ttl),
                                (js3.Supertonic3DurationPredictor,
                                 ps3.Supertonic3DurationPredictor, dp)):
        mod = cls_j(CFG_J)
        params = _perturbed(mod.init(jax.random.PRNGKey(1), ids, mask, style), 1)
        want = np.asarray(mod.apply(params, ids, mask, style))
        got = _load(cls_p(CFG_P), params)(_t(ids), _t(mask), _t(style)).numpy()
        assert got.shape == want.shape and _rel(got, want) <= REL_L2, cls_p.__name__


def _estimator_inputs():
    rs = np.random.RandomState(2)
    L, T = CFG_J.max_latent, CFG_J.text_t
    z = rs.randn(2, js3.LATENT_CH, L).astype(np.float32)
    te = rs.randn(2, 256, T).astype(np.float32) * 0.3
    ttl = rs.randn(2, 50, 256).astype(np.float32) * 0.1
    lmask = np.zeros((2, 1, L), np.float32)
    lmask[0, 0, :11], lmask[1, 0, :5] = 1.0, 1.0
    tmask = np.zeros((2, 1, T), np.float32)
    tmask[0, 0, :20], tmask[1, 0, :9] = 1.0, 1.0
    return z * lmask, te, ttl, lmask, tmask


@pytest.fixture(scope="module")
def estimators():
    est = js3.Supertonic3VectorEstimator(CFG_J)
    args = _estimator_inputs()
    params = _perturbed(est.init(jax.random.PRNGKey(2), *args, np.zeros(2, np.float32),
                                 np.full(2, 8.0, np.float32)), 2)
    return est, params, _load(ps3.Supertonic3VectorEstimator(CFG_P), params)


def test_vector_estimator_step_equals_jax(estimators):
    est, params, port = estimators
    args = _estimator_inputs()
    for step in (0.0, 5.0):
        cur, total = np.full(2, step, np.float32), np.full(2, 8.0, np.float32)
        want = np.asarray(est.apply(params, *args, cur, total))
        got = port(*map(_t, args), _t(cur), _t(total)).numpy()
        assert _rel(got, want) <= REL_L2


def test_estimator_feeds_back_as_in_jax(estimators):
    """The port's side of `test_supertonic_estimator_feedback_contract`: the
    step returns x + v / total (masked), and the seeded init's zero
    `out_proj` leaves x unchanged."""
    _, _, port = estimators
    z, te, ttl, lmask, tmask = map(_t, _estimator_inputs())
    out = port(z, te, ttl, lmask, tmask, torch.zeros(2), torch.full((2,), 8.0))
    assert out.shape == z.shape and torch.isfinite(out).all()
    assert torch.equal(out * (1 - lmask), z * (1 - lmask))
    fresh = ps3.Supertonic3VectorEstimator(CFG_P)
    ps3.random_init_supertonic3_(fresh, torch.Generator().manual_seed(0))
    torch.testing.assert_close(fresh(z, te, ttl, lmask, tmask, torch.zeros(2),
                                     torch.full((2,), 8.0)), z, rtol=0, atol=0)


def test_vocoder_equals_jax():
    voc = js3.Supertonic3Vocoder(CFG_J)
    lat = np.random.RandomState(3).randn(2, js3.LATENT_CH, 5).astype(np.float32)
    params = _perturbed(voc.init(jax.random.PRNGKey(3), lat), 3)
    for i in range(3):  # Snake alphas away from 1, so their layout shows
        for j in range(2):
            params["params"][f"res{i}"][f"alpha{j}"] = np.abs(
                params["params"][f"res{i}"][f"alpha{j}"]) * 2 + 0.3
    want = np.asarray(voc.apply(params, lat))
    got = _load(ps3.Supertonic3Vocoder(CFG_P), params)(_t(lat)).numpy()
    assert got.shape == want.shape == (2, 5 * js3.SAMPLES_PER_LATENT)
    assert _rel(got, want) <= REL_L2


@pytest.fixture(scope="module")
def managers(tmp_path_factory):
    jm = jax_mgr.Supertonic3Manager(CFG_J)
    jm.params = {k: _perturbed(v, i) for i, (k, v) in enumerate(sorted(jm.params.items()))}
    base = tmp_path_factory.mktemp("supertonic3")
    for k, v in jm.params.items():
        save_params(base / f"{k}.npz", v)
    return jm, port_mgr.Supertonic3Manager(CFG_P, checkpoint_dir=base, device="cpu")


@pytest.mark.parametrize("text,voice,lang", [
    ("Hello world, this is a test of the speech system.", "M1", "en"),
    ("Short.", "f3", "en"),
    ("Bonjour tout le monde. Une deuxième phrase, assez longue pour couper le texte en deux.",
     "F1", "fr"),
])
def test_manager_equals_jax(managers, text, voice, lang):
    jm, pm = managers
    cleaned = port_mgr.preprocess_text(text, lang)
    assert cleaned == jax_mgr.preprocess_text(text, lang)
    z_p = ps3.sample_noisy_latent(np.array([0.7]), CFG_P.max_latent, np.random.RandomState(4))
    z_j = js3.sample_noisy_latent(np.array([0.7]), CFG_J.max_latent, np.random.RandomState(4))
    for a, b in zip(z_p, z_j):
        np.testing.assert_array_equal(a, b)
    ids, n = pm.indexer.encode(cleaned, CFG_P.text_t)
    tmask = (np.arange(CFG_P.text_t) < n).astype(np.float32)[None]
    style = pm.voices[port_mgr.parse_voice(voice)]
    te = jm._text_fn(jm.params["text_encoder"], jnp.asarray(ids, jnp.int32)[None],
                     jnp.asarray(tmask), jnp.asarray(style["ttl"])[None])
    args = (z_p[0], np.asarray(te), style["ttl"][None], z_p[1], tmask[:, None, :])
    want_z = np.asarray(jm._get_denoise(8)(jm.params["vector_estimator"], *args))
    got_z = pm.denoise(*map(_t, args), 8).numpy()
    assert _rel(got_z, want_z) <= REL_L2_AUDIO
    want, got = jm.synthesize(text, voice, lang, seed=5), pm.synthesize(text, voice, lang, seed=5)
    assert got.duration == pytest.approx(want.duration, rel=1e-6)
    assert got.samples.shape == want.samples.shape
    assert _rel(got.samples, want.samples) <= REL_L2_AUDIO


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_mgr.Supertonic3Manager(CFG_P)


# ------------------------------------------------- the JAX suites' own cases

BACKEND_MODULES = ("tts", "models.styletts2", "models.supertonic3", "models.kokoro")
BACKEND_EDITS = (("StyleTTS2Manager(STYLETTS2_TEST)", 'StyleTTS2Manager(STYLETTS2_TEST, device="cpu")'),
                 ("Supertonic3Manager(SUPERTONIC3_TEST, total_steps=2)",
                  'Supertonic3Manager(SUPERTONIC3_TEST, total_steps=2, device="cpu")'))
BACKEND_CASES = [c for c in jax_cases("test_tts_backends.py", BACKEND_MODULES,
                                      edits=BACKEND_EDITS, fixtures=True)
                 if c.id != "test_supertonic_estimator_feedback_contract"]
TEXT_CASES = jax_cases("test_supertonic_text.py", ("tts",), fixtures=True, params=True)
globals().update(jax_fixtures("test_tts_backends.py", BACKEND_MODULES, edits=BACKEND_EDITS))


@pytest.mark.parametrize("case", BACKEND_CASES + TEXT_CASES)
def test_jax_backend_case_on_the_port(case, request):
    case(request)


def test_cases_cover_the_jax_suites():
    assert len(BACKEND_CASES) == 26 - 1 and len(TEXT_CASES) == 18
