"""StyleTTS2 of the PyTorch port against the JAX package.

Programs, on JAX's seeded inits loaded through `utils/weights.py`, f32,
STYLETTS2_TEST, ragged rows:
- the text program (ALBERT, bert_encoder, TextEncoder), the style program
  (the two 2-D conv style encoders, the transformer denoiser under the
  ADPM2 sampler with the same noise) and the predict program: REL_L2;
- the acoustic program stage by stage, as `test_torch_kokoro.py` holds
  Kokoro's: prosody (F0, N) REL_L2; the harmonic source SOURCE_REL (its
  phase sums the F0 track's last ulps over the samples); the decoder and
  generator given JAX's source (recorded from a jitted run through
  `jax.debug.callback`, as are JAX's `rand_ini` and noise draws) GEN_REL;
  deterministic, and with JAX's draws.

The trained `styletts2` fixture through both managers (the source
deterministic, the sampler's noise numpy's in both): equal phonemes and
TextCleaner ids, style vectors and duration logits within REL_L2, equal
rounded durations and frame counts, the acoustic program on JAX's source
within GEN_REL and the samples end to end within END_REL;
`eval_styletts2_fixture(device="cpu")` gives JAX's transcripts and
`dur_mae_frames`. The cases of `tests/test_styletts2_frontend.py` run on
the port (`jax_cases`).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidaudio_tpu.models import styletts2 as js
from fluidaudio_tpu.train import fixtures as jax_fx
from fluidaudio_tpu.train import tiny_corpus as tc
from fluidaudio_tpu_torch.models import styletts2 as ps
from fluidaudio_tpu_torch.train import fixtures as port_fx
from fluidaudio_tpu_torch.tts import styletts2_manager as port_mgr
from fluidaudio_tpu_torch.utils.weights import from_jax_params, load_state
from tests.test_torch_custom_vocab import jax_cases, one_torch_thread  # noqa: F401
from tests.test_torch_kokoro import _RecordedJaxDraws

REL_L2 = 1e-5
SOURCE_REL = 1e-3
GEN_REL = 1e-4
END_REL = 1e-2
CFG_J, CFG_P = js.STYLETTS2_TEST, ps.STYLETTS2_TEST


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(x):
    return torch.as_tensor(np.array(x))


def _load(module, params):
    load_state(module, from_jax_params(_np(params)))
    return module


def test_config_fields_are_jax_s():
    assert [f.name for f in dataclasses.fields(ps.StyleTts2Config)] == [
        f.name for f in dataclasses.fields(js.StyleTts2Config)]
    assert dataclasses.asdict(port_fx.styletts2_tiny_config()) == dataclasses.asdict(
        jax_fx.styletts2_tiny_config())
    assert dataclasses.asdict(ps.STYLETTS2_BASE) == dataclasses.asdict(js.STYLETTS2_BASE)


@pytest.fixture(scope="module")
def text_case():
    rs = np.random.RandomState(0)
    ids = rs.randint(1, 178, (2, 16)).astype(np.int32)
    lens = np.array([16, 11], np.int32)
    ids[1, 11:] = 0
    prog = js.StyleTts2TextProgram(CFG_J)
    params = jax.jit(prog.init)(jax.random.PRNGKey(0), ids, lens)
    return ids, lens, prog.apply(params, ids, lens), params


def test_text_program_equals_jax(text_case):
    ids, lens, want, params = text_case
    got = _load(ps.StyleTts2TextProgram(CFG_P, device="cpu"), params)(_t(ids), _t(lens))
    for g, w, name in zip(got, want, ("bert_dur", "d_en", "t_en")):
        assert g.shape == w.shape and _rel(g.numpy(), w) <= REL_L2, name


def test_style_program_equals_jax(text_case):
    """Both style encoders on a ragged mel batch (valid columns 128 and 97,
    the rest edge-replicated), then the sampler's 4 trips with the same
    noise."""
    ids, lens, (bert, _, _), _ = text_case
    rs = np.random.RandomState(1)
    mel = rs.randn(2, CFG_J.n_mels, 128).astype(np.float32)
    frames = np.array([128, 97], np.int32)
    noise_init = rs.randn(2, 2 * CFG_J.style_dim).astype(np.float32)
    noises_aux = rs.randn(4, 2, 2 * CFG_J.style_dim).astype(np.float32)
    args = (mel, frames, np.asarray(bert), lens, noise_init, noises_aux)
    prog = js.StyleTts2StyleProgram(CFG_J)
    params = jax.jit(prog.init)(jax.random.PRNGKey(1), *args)
    want = jax.jit(prog.apply)(params, *args)
    got = _load(ps.StyleTts2StyleProgram(CFG_P, device="cpu"), params)(*map(_t, args))
    for g, w, name in zip(got, want, ("s_pred", "ref_s")):
        assert _rel(g.numpy(), w) <= REL_L2, name
    np.testing.assert_allclose(ps.karras_sigmas(5), js.karras_sigmas(5), rtol=0)


def test_predict_program_equals_jax(text_case):
    _, lens, _, _ = text_case
    rs = np.random.RandomState(2)
    d_en = rs.randn(2, 16, CFG_J.d_model).astype(np.float32)
    s = rs.randn(2, CFG_J.style_dim).astype(np.float32)
    prog = js.StyleTts2PredictProgram(CFG_J)
    params = jax.jit(prog.init)(jax.random.PRNGKey(2), d_en, s, lens)
    want = prog.apply(params, d_en, s, lens)
    got = _load(ps.StyleTts2PredictProgram(CFG_P, device="cpu"), params)(_t(d_en), _t(s),
                                                                         _t(lens))
    for g, w, name in zip(got, want, ("d", "dur_logits")):
        assert _rel(g.numpy(), w) <= REL_L2, name


def _acoustic_case():
    rs = np.random.RandomState(6)
    T, F = 10, 32
    d = rs.randn(1, T, CFG_J.d_model + CFG_J.style_dim).astype(np.float32)
    t_en = rs.randn(1, T, CFG_J.d_model).astype(np.float32)
    frame_idx = np.minimum(np.arange(F) // 3, T - 1)[None].astype(np.int32)
    s, ref = (rs.randn(1, CFG_J.style_dim).astype(np.float32) for _ in range(2))
    return d, t_en, frame_idx, np.array([29], np.int32), s, ref


@pytest.mark.parametrize("deterministic", [True, False])
def test_acoustic_program_equals_jax(deterministic, monkeypatch):
    """A voiced F0 track (~150 Hz): prosody REL_L2, the harmonic source
    SOURCE_REL, the decoder and generator on JAX's source GEN_REL."""
    args = _acoustic_case()
    prog = js.StyleTts2AcousticProgram(CFG_J, deterministic=deterministic)
    params = _np(jax.jit(prog.init)({"params": jax.random.PRNGKey(3),
                                     "noise": jax.random.PRNGKey(4)}, *args))
    params["params"]["prosody"]["f0_proj"]["bias"] = np.full((1,), 150.0, np.float32)
    source = {}
    jax_source = js.HifiSourceModule.__call__

    def recorded(self, f0_up):
        har = jax_source(self, f0_up)
        jax.debug.callback(lambda v: source.setdefault("har", np.asarray(v)), har)
        return har

    monkeypatch.setattr(js.HifiSourceModule, "__call__", recorded)
    run = jax.jit(lambda p, *a: prog.apply(p, *a, rngs={"noise": jax.random.PRNGKey(7)},
                                           with_prosody=True))
    with _RecordedJaxDraws() as draws:
        want, wf0, wn = jax.block_until_ready(run(params, *map(jnp.asarray, args)))
    assert sorted(draws) == ([] if deterministic else ["noise", "rand_ini"])

    port = _load(ps.StyleTts2AcousticProgram(CFG_P, deterministic, device="cpu"), params)
    noise = {k: _t(v) for k, v in draws.items()}
    own = {}
    port.decoder.generator.m_source.register_forward_hook(
        lambda m, i, o: own.update(har=o.numpy()))
    port(*map(_t, args), **noise)
    assert _rel(own["har"], source["har"]) <= SOURCE_REL
    monkeypatch.setattr(ps.HifiSourceModule, "forward",
                        lambda self, f0_up, *a, **k: _t(source["har"]))
    got, gf0, gn = port(*map(_t, args), with_prosody=True, **noise)
    assert _rel(gf0.numpy(), wf0) <= REL_L2 and _rel(gn.numpy(), wn) <= REL_L2
    assert got.shape == want.shape == (1, ps.generator_output_length(CFG_P, 64))
    assert _rel(got.numpy(), want) <= GEN_REL


def test_source_draws_come_from_the_generator():
    src = ps.HifiSourceModule(device="cpu")
    f0 = torch.full((1, 600), 150.0)

    def run(seed):
        return src(f0, generator=torch.Generator().manual_seed(seed)).detach().numpy()

    a, b, c = run(1), run(1), run(2)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


# ---------------------------------------------------------- trained fixture


@pytest.fixture(scope="module")
def managers():
    return jax_fx.load_styletts2_manager(), port_fx.load_styletts2_manager(device="cpu")


@pytest.mark.parametrize("u,ids", [(0, [3, 7, 12]), (1, [15, 0]), (2, [5, 9, 2, 14, 1, 8])])
def test_trained_fixture_equals_jax(managers, u, ids, monkeypatch):
    jm, pm = managers
    text = tc.transcript_text(np.asarray(ids))
    ref = jax_fx.styletts2_ref_clip()
    phonemes = pm.phonemizer.phonemize(text)
    assert phonemes == jm.phonemizer.phonemize(text)
    tok = port_mgr.text_cleaner_encode(phonemes)
    tokens = np.zeros((1, 64), np.int32)
    tokens[0, : len(tok)] = tok
    lengths = np.array([len(tok)], np.int32)
    bert, d_en, t_en = jm._text_fn(jm.params["text"], tokens, lengths)
    mel_pad, used = port_mgr.ref_mel_padded(ref, jm.cfg.n_mels)
    noise_init, noises_aux = pm.style_noise(u)
    want_styles = jm._style_fn(jm.params["style"], mel_pad, np.array([used], np.int32), bert,
                               lengths, noise_init, noises_aux)
    got_styles = pm.styles(*pm.text_prog(_t(tokens).long(), _t(lengths))[:1], _t(lengths), ref, u)
    for g, w in zip(got_styles, want_styles):
        assert _rel(g, w) <= REL_L2
    _, s128 = js.blend_style(np.asarray(want_styles[0]), np.asarray(want_styles[1]))
    d, want_logits = jm._predict_fn(jm.params["predict"], d_en, s128, lengths)
    _, got_logits = pm.predict_prog(_t(d_en), _t(s128), _t(lengths))
    assert _rel(got_logits.numpy(), want_logits) <= REL_L2
    want_dur = js.round_durations(np.asarray(want_logits)[0], len(tok))
    np.testing.assert_array_equal(ps.round_durations(got_logits.numpy()[0], len(tok)), want_dur)

    source = {}
    jax_source = js.HifiSourceModule.__call__

    def recorded(self, f0_up):
        har = jax_source(self, f0_up)
        jax.debug.callback(lambda v: source.setdefault("har", np.asarray(v)), har)
        return har

    monkeypatch.setattr(js.HifiSourceModule, "__call__", recorded)
    # a fresh trace, so that the recording callback is in it
    monkeypatch.setattr(jm, "_acoustic_fn",
                        jax.jit(lambda p, *a: jm.acoustic_prog.apply(p, *a)))
    want = jm.synthesize(text, reference_audio=ref, noise_seed=u).samples
    got = pm.synthesize(text, reference_audio=ref, noise_seed=u).samples
    assert got.shape == want.shape
    assert _rel(got, want) <= END_REL
    # the acoustic program on JAX's source (the last synthesize call's)
    monkeypatch.setattr(ps.HifiSourceModule, "forward",
                        lambda self, f0_up, *a, **k: _t(source["har"]))
    got_src = pm.synthesize(text, reference_audio=ref, noise_seed=u).samples
    assert _rel(got_src, want) <= GEN_REL


def test_eval_styletts2_fixture_equals_jax(managers, monkeypatch):
    """`eval_styletts2_fixture` on the port: JAX's `dur_mae_frames` and
    roundtrip WER, and each utterance's transcript equal to the trained
    ASR's reading of JAX's synthesis."""
    from fluidaudio_tpu.asr.config import ASRConfig
    from fluidaudio_tpu.asr.manager import AsrManager
    from fluidaudio_tpu.models.zoo import AsrModels
    from fluidaudio_tpu.tts.roundtrip import TINY_CORPUS_CHANNEL
    from fluidaudio_tpu.utils.converter import resample

    jm, _ = managers
    got = port_fx.eval_styletts2_fixture(device="cpu")
    asr = AsrManager(AsrModels.load("test-tiny", checkpoint_dir=jax_fx.trained_assets_dir() / "asr",
                                    allow_random_init=False), ASRConfig())
    rs = np.random.RandomState(6174)
    want = []
    ref = jax_fx.styletts2_ref_clip()
    for u in range(3):
        text = tc.transcript_text(rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 8))))
        samples = jm.synthesize(text, reference_audio=ref, noise_seed=u).samples
        want.append((text, asr.transcribe(TINY_CORPUS_CHANNEL.apply(
            resample(samples, 24_000, 16_000))).text))
    assert got["utterances"] == want
    monkeypatch.setattr(jax_fx, "load_styletts2_manager", lambda: jm)  # the same weights
    jax_eval = jax_fx.eval_styletts2_fixture()
    assert got["dur_mae_frames"] == pytest.approx(jax_eval["dur_mae_frames"], abs=1e-12)
    assert got["roundtrip_wer_avg"] == pytest.approx(jax_eval["roundtrip_wer_avg"], abs=1e-12)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_mgr.StyleTTS2Manager(CFG_P)


# ------------------------------------------------- the JAX suites' own cases

FRONTEND_CASES = jax_cases("test_styletts2_frontend.py", ("tts", "models.styletts2"),
                           fixtures=True, params=True)


@pytest.mark.parametrize("case", FRONTEND_CASES)
def test_jax_styletts2_frontend_case_on_the_port(case, request):
    case(request)


def test_cases_cover_the_jax_suite():
    assert len(FRONTEND_CASES) == 28
