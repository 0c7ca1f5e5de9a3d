"""Kokoro TTS of the PyTorch port against the JAX package.

Modules, on JAX's seeded inits loaded through `utils/weights.py`, in f32:
- `BiLstm` with ragged lengths (padding never reaches the valid region of
  the backward pass; padded outputs exactly zero): REL_L2.
- `conv_transpose_1d` for both kernel kinds, at shapes where a wrong layout
  would fit (a cube `up_kernel` [k, in, out] with k = in = out; the Snake
  alpha at T = C): REL_L2, and the wrong layouts are shown to fail.
- `stft_20` / `istft_20`: magnitudes and the inverse REL_L2; phases equal
  (mod 2 pi) wherever the magnitude is above MAG_FLOOR; `angle(0) = 0`.
  Below the floor the phase of a rounding-level bin is not a function of
  the input: two FFT libraries give different angles for a bin of 1e-8.
- `AdaIN1d` with and without a mask; `KokoroTextProgram` (durations before
  rounding, d, t_en) on ragged rows: REL_L2.
- `KokoroAudioProgram` on a tiny config, deterministic and with JAX's own
  noise draws (recorded from a jitted run through `jax.debug.callback` and
  fed to the port's source module), stage by stage: prosody REL_L2, the
  harmonic source SOURCE_REL, the generator and iSTFT on JAX's source STFT
  GEN_REL.

Why the stages. The harmonic source's phase is a cumsum times 2 pi 300,
thousands of radians: the port sums in XLA:CPU's order (`blocked_cumsum`,
bit-equal to JAX's), but the F0 track feeding it carries the prosody's 1e-7
relative differences, which the phase integrates over the utterance, and
the generator reads the source's STFT phases, which are ill-conditioned in
its weak bins. On FLIP_TEXT the port is 1.0e-3 from JAX's op-by-op run,
which is itself 4.1e-3 from JAX's jitted run.

The trained `tts` fixture through both managers with JAX's draws: equal
phonemes, durations within REL_L2 before rounding, equal frame counts; the
audio program within JIT_REL of JAX's jitted program, the samples' log
spectrogram within SPEC_REL and the samples within SAMPLES_REL of JAX's
jitted synthesis (measured: 1.9e-3, 6.9e-2 and 3.7e-3 for the three texts;
JAX's jitted-vs-op-by-op spread on them 1.8e-3, 1.1e-2 and 3.0e-3), and
within JIT_REL once the two are brought to one gain. The manager divides
by the peak sample, the statistic most sensitive to the source's phase:
on "w15 w0" the two peaks (same sample) differ by 7.4%, which is all but
6.9e-3 of the 6.9e-2.
`eval_tts_fixture`'s per-utterance transcripts and `dur_mae_frames` equal
JAX's (see FLIP_TEXT for the one word where JAX's jit slips). Port on port:
the JAX suite's `test_synthesize_from_phonemes_matches_text_path`
(`array_equal`) and `test_output_is_tonal_at_word_frequencies`, and the
cases of `tests/test_tts_kokoro.py` (the mandarin variant's included; but
the real-weights roundtrip) and `tests/test_tts_chain.py::test_kokoro_chain`.
The mandarin variant gives JAX's bopomofo and phoneme ids on Hanzi input.
"""

from __future__ import annotations

import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidaudio_tpu.models import kokoro as jk
from fluidaudio_tpu.models import rnn as jax_rnn
from fluidaudio_tpu.train import fixtures as jax_fx
from fluidaudio_tpu.train import tiny_corpus as tc
from fluidaudio_tpu_torch.models import kokoro as pk
from fluidaudio_tpu_torch.models import rnn as port_rnn
from fluidaudio_tpu_torch.train import fixtures as port_fx
from fluidaudio_tpu_torch.tts.kokoro_manager import KokoroManager
from fluidaudio_tpu_torch.utils.weights import from_jax_params, load_state
from tests.test_torch_custom_vocab import jax_cases, one_torch_thread  # noqa: F401

REL_L2 = 1e-5
AUDIO_REL = 5e-3
JIT_REL = 1e-2
SAMPLES_REL = 1e-1
SPEC_REL = 3e-2
SOURCE_REL = 1e-3
GEN_REL = 1e-4
MAG_FLOOR = 1e-3
TINY = dict(d_model=32, style_dim=16, n_layer=2, max_dur=8, albert_emb=16, albert_hidden=48,
            albert_heads=4, albert_inter=64, albert_layers=1, decoder_hidden=48, asr_res_ch=8,
            upsample_initial=32, max_frames=64)
#: the audio-program comparison's config: one resblock per stage keeps JAX's
#: compile of the jitted program short
TINY_AUDIO = dict(TINY, resblock_kernels=(3,), resblock_dilations=((1, 3),))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, params):
    load_state(module, from_jax_params(_np_tree(params)))
    return module


def _t(x, dtype=None):
    x = torch.as_tensor(np.asarray(x))
    return x if dtype is None else x.to(dtype)


# ------------------------------------------------------------------ modules


def test_bilstm_ragged_lengths_equal_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 11, 6).astype(np.float32)
    lengths = np.array([11, 7, 1], np.int32)
    mod = jax_rnn.BiLstm(5)
    params = mod.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(lengths))
    want = np.asarray(mod.apply(params, jnp.asarray(x), jnp.asarray(lengths)))
    port = _load(port_rnn.BiLstm(6, 5, device="cpu"), params)
    with torch.no_grad():
        got = port(_t(x), _t(lengths)).numpy()
        # garbage in the padding changes nothing
        x2 = x.copy()
        x2[1, 7:] = 1e3
        got2 = port(_t(x2), _t(lengths)).numpy()
    assert _rel(got, want) <= REL_L2
    np.testing.assert_array_equal(got2, got)
    assert not got[1, 7:].any() and not got[2, 1:].any()


def test_reverse_by_length_is_exact():
    x = np.random.RandomState(1).randn(2, 6, 3).astype(np.float32)
    lengths = np.array([4, 6], np.int32)
    want = np.asarray(jax_rnn.reverse_by_length(jnp.asarray(x), jnp.asarray(lengths)))
    np.testing.assert_array_equal(port_rnn.reverse_by_length(_t(x), _t(lengths)).numpy(), want)


def _weight(name: str, kernel: np.ndarray) -> torch.Tensor:
    return _t(from_jax_params({"params": {name: kernel}})[name])


@pytest.mark.parametrize("k,ch,c,r", [(4, 4, 4, 2), (20, 16, 8, 10), (12, 8, 4, 6)])
def test_up_kernel_conv_transpose_equals_jax(k, ch, c, r):
    """`up_kernel_i` [k, ch, c] (groups 1). At k = ch = c the generic Conv1d
    rule ([out, in, k]) and a flip both fit the shape: they must not pass."""
    rs = np.random.RandomState(k)
    x = rs.randn(2, 9, ch).astype(np.float32)
    kern = rs.randn(k, ch, c).astype(np.float32)
    pad = (k - r) // 2
    want = np.asarray(jk.conv_transpose_1d(jnp.asarray(x), jnp.asarray(kern), r, pad))
    conv = functools.partial(torch.nn.functional.conv_transpose1d, _t(x).transpose(1, 2),
                             stride=r, padding=pad)
    got = conv(_weight("up_kernel_0", kern)).transpose(1, 2).numpy()
    assert got.shape == want.shape and _rel(got, want) <= REL_L2
    if k == ch == c:
        generic = _t(kern.transpose(2, 1, 0).copy())
        flipped = _t(kern[::-1].transpose(1, 2, 0).copy())
        for wrong in (generic, flipped):
            assert _rel(conv(wrong).transpose(1, 2).numpy(), want) > 0.1


@pytest.mark.parametrize("C", [3, 8])
def test_pool_kernel_conv_transpose_equals_jax(C):
    """The depthwise `pool_kernel` [3, 1, C] (stride 2, pad 1, out_pad 1,
    groups C) -> [C, 1, 3]."""
    rs = np.random.RandomState(C)
    x = rs.randn(2, 7, C).astype(np.float32)
    kern = rs.randn(3, 1, C).astype(np.float32)
    want = np.asarray(jk.conv_transpose_1d(jnp.asarray(x), jnp.asarray(kern), 2, 1,
                                           out_pad=1, groups=C))
    w = _weight("pool_kernel", kern)
    assert tuple(w.shape) == (C, 1, 3)
    got = torch.nn.functional.conv_transpose1d(_t(x).transpose(1, 2), w, stride=2, padding=1,
                                               output_padding=1, groups=C)
    assert _rel(got.transpose(1, 2).numpy(), want) <= REL_L2


def test_snake_resblock_alpha_layout_at_t_equal_c():
    """`AdaINResBlock1` with T == C, where `alpha [1, 1, C]` would broadcast
    over time unnoticed; distinct alphas per channel."""
    C = T = 8
    rs = np.random.RandomState(2)
    x = rs.randn(2, T, C).astype(np.float32)
    s = rs.randn(2, 5).astype(np.float32)
    mod = jk.AdaINResBlock1(C, 3, (1, 3))
    params = _np_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(s)))
    for name in ("alpha1_0", "alpha2_0", "alpha1_1", "alpha2_1"):
        params["params"][name] = (0.5 + rs.rand(1, 1, C)).astype(np.float32)
    want = np.asarray(mod.apply(params, jnp.asarray(x), jnp.asarray(s)))
    port = _load(pk.AdaINResBlock1(5, C, 3, (1, 3), device="cpu"), params)
    with torch.no_grad():
        got = port(_t(x).transpose(1, 2), _t(s)).transpose(1, 2).numpy()
    assert _rel(got, want) <= REL_L2


@pytest.mark.parametrize("masked", [False, True])
def test_adain1d_equals_jax(masked):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 10, 6).astype(np.float32)
    s = rs.randn(2, 4).astype(np.float32)
    mask = (np.arange(10)[None, :] < np.array([10, 6])[:, None]).astype(np.float32)[..., None]
    mod = jk.AdaIN1d(6)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(s))
    params = jax.tree_util.tree_map(lambda p: p + 0.3, params)  # a nonzero fc
    m = jnp.asarray(mask) if masked else None
    want = np.asarray(mod.apply(params, jnp.asarray(x), jnp.asarray(s), m))
    port = _load(pk.AdaIN1d(4, 6, device="cpu"), params)
    with torch.no_grad():
        got = port(_t(x).transpose(1, 2), _t(s),
                   _t(mask).transpose(1, 2) if masked else None).transpose(1, 2).numpy()
    assert _rel(got, want) <= REL_L2


@pytest.mark.parametrize("n_fft,hop", [(20, 5), (20, 1)])
def test_stft_istft_equal_jax(n_fft, hop):
    rs = np.random.RandomState(hop)
    x = rs.randn(2, 300).astype(np.float32)
    jm, jp = (np.asarray(a) for a in jk.stft_20(jnp.asarray(x), n_fft, hop))
    pm, pp = (a.numpy() for a in pk.stft_20(_t(x), n_fft, hop))
    assert _rel(pm, jm) <= REL_L2
    big = jm > MAG_FLOOR
    assert big.mean() > 0.9
    np.testing.assert_allclose(np.angle(np.exp(1j * (pp - jp)))[big], 0.0, atol=1e-4)
    mag = np.abs(rs.randn(2, 61, n_fft // 2 + 1)).astype(np.float32)
    ph = rs.uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
    want = np.asarray(jk.istft_20(jnp.asarray(mag), jnp.asarray(ph), n_fft, hop))
    got = pk.istft_20(_t(mag), _t(ph), n_fft, hop).numpy()
    assert got.shape == want.shape and _rel(got, want) <= REL_L2
    # a round trip gives the signal back (hop 5: the window sum covers it)
    back = pk.istft_20(*pk.stft_20(_t(x), n_fft, hop), n_fft, hop).numpy()
    np.testing.assert_allclose(back, x[:, : back.shape[1]], atol=1e-4)


def test_angle_of_zero_is_zero():
    _, jp = jk.stft_20(jnp.zeros((1, 40)), 20, 5)
    _, pp = pk.stft_20(torch.zeros(1, 40), 20, 5)
    assert not np.asarray(jp).any() and not pp.numpy().any()


def test_linear_resize_and_blocked_cumsum_are_jax_s():
    rs = np.random.RandomState(4)
    x = rs.rand(2, 37, 3).astype(np.float32)
    for n in (5, 37, 111):
        np.testing.assert_allclose(pk.linear_resize(_t(x), n).numpy(),
                                   np.asarray(jk.linear_resize(jnp.asarray(x), n)), rtol=0,
                                   atol=1e-7)
    for n in (7, 320, 4000):  # bit-equal to XLA:CPU's cumsum
        y = (rs.rand(1, n, 9) * 0.3).astype(np.float32)
        np.testing.assert_array_equal(pk.blocked_cumsum(_t(y)).numpy(),
                                      np.asarray(jax.jit(lambda v: jnp.cumsum(v, 1))(y)))


# ---------------------------------------------------------------- programs


def _text_case(cfg_j):
    rs = np.random.RandomState(5)
    ids = rs.randint(1, cfg_j.vocab_size, size=(2, 24)).astype(np.int32)
    lengths = np.array([24, 13], np.int32)
    ids[1, 13:] = 0
    style = rs.randn(2, cfg_j.style_dim).astype(np.float32)
    return ids, lengths, style


def test_text_program_equals_jax():
    cfg_j = jk.KokoroConfig(**TINY)
    ids, lengths, style = _text_case(cfg_j)
    prog = jk.KokoroTextProgram(cfg_j)
    params = jax.jit(prog.init)(jax.random.PRNGKey(2), jnp.asarray(ids), jnp.asarray(lengths),
                                jnp.asarray(style))
    want = prog.apply(params, jnp.asarray(ids), jnp.asarray(lengths), jnp.asarray(style), 1.25)
    port = _load(pk.KokoroTextProgram(pk.KokoroConfig(**TINY), device="cpu"), params)
    got = port(_t(ids), _t(lengths), _t(style), 1.25)
    for g, w, name in zip(got, want, ("duration", "d", "t_en")):
        assert g.shape == w.shape and _rel(g.numpy(), w) <= REL_L2, name
    assert not got[2][1, 13:].numpy().any()  # t_en masked past the length


def _audio_case(cfg_j, n_frames):
    rs = np.random.RandomState(6)
    T, F = 10, 32
    d = rs.randn(1, T, cfg_j.d_model + cfg_j.style_dim).astype(np.float32)
    t_en = rs.randn(1, T, cfg_j.d_model).astype(np.float32)
    frame_idx = np.minimum(np.arange(F) // 3, T - 1)[None].astype(np.int32)
    s, tim = (rs.randn(1, cfg_j.style_dim).astype(np.float32) for _ in range(2))
    return d, t_en, frame_idx, np.array([n_frames], np.int32), s, tim


class _RecordedJaxDraws:
    """While active, `jax.random.uniform` / `normal` draw as before and also
    send each draw to the host (`jax.debug.callback`), so that a jitted run
    (traced while active) records JAX's own draws: `rand_ini`, then `noise`."""

    def __enter__(self):
        self.draws, self.orig = {}, (jax.random.uniform, jax.random.normal)

        def recorded(fn, name):
            def draw(*args, **kwargs):
                value = fn(*args, **kwargs)
                jax.debug.callback(lambda v: self.draws.setdefault(name, np.asarray(v)), value)
                return value
            return draw

        jax.random.uniform = recorded(self.orig[0], "rand_ini")
        jax.random.normal = recorded(self.orig[1], "noise")
        return self.draws

    def __exit__(self, *exc):
        jax.random.uniform, jax.random.normal = self.orig


@pytest.mark.parametrize("deterministic", [True, False])
def test_audio_program_equals_jax(deterministic, monkeypatch):
    """The tiny config, stage by stage against JAX's jitted program (noisy:
    JAX's own draws, recorded, fed to the port's source module):
    - prosody (F0, N): REL_L2;
    - the harmonic source: SOURCE_REL (sin at thousands of radians in two
      libraries);
    - the generator and iSTFT on JAX's harmonic STFT (recorded, and given to
      the port's generator in place of its own): GEN_REL. At random init the
      STFT phases of the source's weak bins (|X| ~ 1e-3 of the peak) turn the
      source's 1e-4 into several percent, so the port's own STFT is held to
      JAX's only where it is well conditioned (`test_stft_istft_equal_jax`).
    """
    cfg_j = jk.KokoroConfig(**TINY_AUDIO)
    args = _audio_case(cfg_j, 32 if deterministic else 27)
    prog = jk.KokoroAudioProgram(cfg_j, deterministic=deterministic)
    jargs = [jnp.asarray(a) for a in args]
    params = _np_tree(jax.jit(prog.init)({"params": jax.random.PRNGKey(3),
                                          "noise": jax.random.PRNGKey(4)}, *jargs))
    # a voiced F0 track (~150 Hz) over the whole grid
    params["params"]["prosody"]["f0_proj"]["bias"] = np.full((1,), 150.0, np.float32)
    spec = {}
    jax_stft = jk.stft_20

    def recorded_stft(x, *a):
        mag, ph = jax_stft(x, *a)
        jax.debug.callback(lambda *v: spec.update(zip(("har", "mag", "phase"), v)), x, mag, ph)
        return mag, ph

    monkeypatch.setattr(jk, "stft_20", recorded_stft)
    run = jax.jit(lambda p, *a: prog.apply(p, *a, rngs={"noise": jax.random.PRNGKey(7)},
                                           with_prosody=True))
    with _RecordedJaxDraws() as draws:
        want, wf0, wn = jax.block_until_ready(run(params, *jargs))
    assert sorted(draws) == ([] if deterministic else ["noise", "rand_ini"])

    port = _load(pk.KokoroAudioProgram(pk.KokoroConfig(**TINY_AUDIO), deterministic,
                                       device="cpu"), params)
    har = {}
    port.decoder.generator.m_source.register_forward_hook(
        lambda m, i, o: har.setdefault("har", o.numpy()))
    monkeypatch.setattr(pk, "stft_20", lambda x, *a: (_t(spec["mag"]), _t(spec["phase"])))
    noise = {k: _t(v) for k, v in draws.items()}
    got, gf0, gn = port(*(_t(a) for a in args), with_prosody=True, **noise)
    assert _rel(gf0.numpy(), wf0) <= REL_L2 and _rel(gn.numpy(), wn) <= REL_L2
    assert _rel(har["har"], spec["har"]) <= SOURCE_REL
    assert got.shape == want.shape == (1, 32 * pk.HOP)
    assert _rel(got.numpy(), want) <= GEN_REL
    assert np.isfinite(got.numpy()).all()


def test_audio_program_draws_from_its_generator():
    """Without given draws the source samples `rand_ini` then `noise` from
    the generator: the same seed gives the same samples, another does not."""
    cfg = pk.KokoroConfig(**TINY)
    prog = pk.KokoroAudioProgram(cfg, device="cpu")
    pk.random_init_kokoro_(prog, torch.Generator().manual_seed(0))
    args = [_t(a) for a in _audio_case(jk.KokoroConfig(**TINY), 30)]
    def run(seed):
        return prog(*args, generator=torch.Generator().manual_seed(seed)).numpy()

    a, b, c = run(1), run(1), run(2)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c) and np.isfinite(a).all()


# ---------------------------------------------------------- trained fixture


@pytest.fixture(scope="module")
def managers():
    return jax_fx.load_tts_manager(), port_fx.load_tts_manager(device="cpu")


@pytest.fixture(scope="module")
def jax_fixture_draws(managers):
    """JAX's harmonic-source draws for the fixture's 160-frame bucket, from a
    jitted run: the manager uses one key for every chunk, so every chunk
    takes these."""
    jm, _ = managers
    cfg = jm.cfg
    run = jax.jit(lambda p, *a: jm.audio_program.apply(p, *a, rngs={"noise": jm._noise_key}))
    with _RecordedJaxDraws() as draws:
        jax.block_until_ready(run(
            jm.params["audio"], jnp.zeros((1, 8, cfg.d_model + cfg.style_dim)),
            jnp.zeros((1, 8, cfg.d_model)), jnp.zeros((1, 160), jnp.int32), jnp.array([16]),
            jnp.zeros((1, cfg.style_dim)), jnp.zeros((1, cfg.style_dim))))
    return {k: _t(v) for k, v in draws.items()}


@pytest.fixture()
def port_with_jax_draws(monkeypatch, jax_fixture_draws):
    """The port's audio program fed JAX's draws instead of its generator's."""
    forward = pk.KokoroAudioProgram.forward

    def with_draws(self, *args, **kwargs):
        kwargs.pop("generator", None)
        return forward(self, *args, **jax_fixture_draws, **kwargs)

    monkeypatch.setattr(pk.KokoroAudioProgram, "forward", with_draws)


#: seed 8642's first `eval_tts_fixture` utterance. JAX's jitted synthesis
#: reads "w15 w11 w0" through the trained ASR; its op-by-op synthesis (each
#: XLA op alone, `jax.disable_jit()`) is 4.1e-3 from the jitted one and reads
#: "w15 w11 w1", as the port's does (the port is 1.0e-3 from the op-by-op
#: run): XLA's fusion numerics flip the reading of the last tone word.
FLIP_TEXT = "w15 w11 w1"


def _log_spectrogram(x: np.ndarray) -> np.ndarray:
    """log(1e-3 + |STFT|) on 25 ms Hann frames at a 12.5 ms hop."""
    n, hop = 600, 300
    frames = np.lib.stride_tricks.sliding_window_view(x, n)[::hop] * np.hanning(n)
    return np.log(1e-3 + np.abs(np.fft.rfft(frames, axis=-1)))


@pytest.mark.parametrize("ids", [[3, 7, 12], [15, 0], [5, 9, 2, 14, 1, 8]])
def test_trained_fixture_equals_jax(managers, port_with_jax_draws, ids):
    """Phonemes equal; durations before rounding within REL_L2 and away from
    a rounding tie, the same frame count; with the same draws, the audio
    program's output (the whole 160-frame bucket) within JIT_REL of JAX's
    jitted program, the samples' log spectrogram within SPEC_REL, the
    samples within SAMPLES_REL of JAX's jitted synthesis, and within JIT_REL
    after the least-squares gain between them (the peak normalisation's)."""
    jm, pm = managers
    text = tc.transcript_text(np.asarray(ids))
    phonemes = pm.phonemes_for(text)
    assert phonemes == jm.phonemes_for(text)
    tok = [0, *pm.encode_phonemes(phonemes), 0]
    tokens = np.zeros((1, 64), np.int32)
    tokens[0, : len(tok)] = tok
    style = jm.voices["af_test"][len(phonemes) - 1][128:][None].astype(np.float32)
    timbre = jm.voices["af_test"][len(phonemes) - 1][:128][None].astype(np.float32)
    want_dur, d, t_en = jm._text_fn(jm.params["text"], jnp.asarray(tokens),
                                    jnp.asarray([len(tok)], jnp.int32), jnp.asarray(style),
                                    jnp.float32(1.0))
    want_dur = np.asarray(want_dur[0, : len(tok)])
    got_dur, _, _ = pm.text_durations(pm.encode_phonemes(phonemes), _t(style))
    assert _rel(got_dur, want_dur) <= REL_L2
    assert np.abs(np.abs(want_dur - np.floor(want_dur)) - 0.5).min() > 1e-3  # no x.5 tie
    frame_idx, frames = jk.expand_durations(want_dur, jm.cfg.max_frames)
    assert pk.expand_durations(got_dur, pm.cfg.max_frames)[1] == frames
    program_args = (d, t_en, frame_idx[None, :160], np.array([frames], np.int32), style, timbre)
    want_program = np.asarray(jm._audio_fn(jm.params["audio"], *map(jnp.asarray, program_args),
                                           key=jm._noise_key))
    got_program = pm.audio_program(*(_t(np.asarray(a)) for a in program_args))
    assert _rel(got_program.numpy(), want_program) <= JIT_REL
    got = pm.synthesize(text).samples
    want = jm.synthesize(text).samples
    assert got.shape == want.shape == (frames * pk.HOP,)
    assert _rel(_log_spectrogram(got), _log_spectrogram(want)) <= SPEC_REL
    assert _rel(got, want) <= SAMPLES_REL
    gain = float(got.astype(np.float64) @ want / (got.astype(np.float64) @ got))
    assert _rel(gain * got, want) <= JIT_REL


def test_eval_tts_fixture_transcripts_and_durations_equal_jax(managers, port_with_jax_draws):
    """Per utterance of seed 8642 the port's roundtrip transcript equals the
    trained ASR's transcript of JAX's jitted synthesis, but for FLIP_TEXT,
    where the port reads the text as JAX's op-by-op synthesis does (see
    FLIP_TEXT) and JAX's jitted synthesis keeps its one-word slip;
    `dur_mae_frames` equals JAX's `eval_tts_fixture` value."""
    from fluidaudio_tpu.asr.config import ASRConfig
    from fluidaudio_tpu.asr.manager import AsrManager
    from fluidaudio_tpu.models.zoo import AsrModels
    from fluidaudio_tpu.tts.roundtrip import TINY_CORPUS_CHANNEL
    from fluidaudio_tpu.utils.converter import resample

    jm, _ = managers
    asr = AsrManager(AsrModels.load("test-tiny", checkpoint_dir=jax_fx.trained_assets_dir() / "asr",
                                    allow_random_init=False), ASRConfig())
    got = port_fx.eval_tts_fixture(device="cpu")
    rs = np.random.RandomState(8642)
    want = []
    for _ in range(3):
        text = tc.transcript_text(rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 9))))
        jitted = asr.transcribe(TINY_CORPUS_CHANNEL.apply(
            resample(jm.synthesize(text).samples, 24_000, 16_000))).text
        if text == FLIP_TEXT:
            assert jitted == "w15 w11 w0"
            jitted = FLIP_TEXT
        want.append((text, jitted))
    assert FLIP_TEXT in {t for t, _ in want}
    assert got["utterances"] == want
    jax_eval = jax_fx.eval_tts_fixture()
    assert got["dur_mae_frames"] == pytest.approx(jax_eval["dur_mae_frames"], rel=REL_L2)


def test_two_calls_give_equal_samples(managers):
    _, pm = managers
    text = tc.transcript_text(np.array([4, 10, 6]))
    np.testing.assert_array_equal(pm.synthesize(text).samples, pm.synthesize(text).samples)


def test_mandarin_waits_for_its_g2p():
    """The mandarin variant no longer waits for its G2P: on Hanzi input
    (numbers, polyphones, sandhi, punctuation) it gives JAX's bopomofo and
    phoneme ids, and its seed vocabulary is JAX's."""
    from fluidaudio_tpu.tts.kokoro_manager import KokoroManager as JaxKokoroManager

    text = "今天是2024年3月15日，我们一起去银行。你好，我不想说话！"
    jm = JaxKokoroManager(variant="mandarin", config=jk.KokoroConfig(**TINY))
    pm = KokoroManager(variant="mandarin", config=pk.KokoroConfig(**TINY), device="cpu")
    assert pm.vocab == jm.vocab and pm.default_voice == jm.default_voice
    assert pm.phonemes_for(text) == jm.phonemes_for(text)
    assert pm.encode_phonemes(pm.phonemes_for(text)) == jm.encode_phonemes(jm.phonemes_for(text))
    assert pm.phonemes_for("ㄋㄧ3ㄏㄠ3") == "ㄋㄧ3ㄏㄠ3"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        KokoroManager(config=pk.KokoroConfig(**TINY))


def test_checkpoint_dir_none_reads_the_model_cache(tmp_path, monkeypatch):
    from fluidaudio_tpu_torch.registry import DownloadUtils, Repo

    monkeypatch.setenv("FLUID_CACHE_DIR", str(tmp_path))
    folder = DownloadUtils.repo_dir(Repo.KOKORO_ANE)
    shutil.copytree(jax_fx.trained_assets_dir() / "tts", folder)
    mgr = KokoroManager(default_voice="af_test", config=port_fx.kokoro_tiny_config(),
                        device="cpu")
    assert mgr.has_real_weights and mgr.available_voices == ["af_test"]


# ------------------------------------------------- the JAX suites' own cases

KOKORO_EDITS = (
    ("mgr_mod.KokoroManager(config=cfg)", 'mgr_mod.KokoroManager(config=cfg, device="cpu")'),
    ('KokoroManager(variant="japanese", config=KokoroConfig(**_TINY_CFG))',
     'KokoroManager(variant="japanese", config=KokoroConfig(**_TINY_CFG), device="cpu")'),
    ('KokoroManager(variant="mandarin", config=KokoroConfig(**_TINY_CFG))',
     'KokoroManager(variant="mandarin", config=KokoroConfig(**_TINY_CFG), device="cpu")'),
)
KOKORO_CASES = [c for c in jax_cases("test_tts_kokoro.py", edits=KOKORO_EDITS, fixtures=True)
                if not c.id.startswith("TestAsrRoundtripRealWeights")]
CHAIN_CASES = jax_cases("test_tts_chain.py", ("tts", "utils"), ("test_kokoro_chain",),
                        edits=(("KokoroManager().synthesize(TEXT)",
                                'KokoroManager(device="cpu").synthesize(TEXT)'),),
                        fixtures=True)
TRAINED_CASES = jax_cases(
    "test_trained_fixtures.py", ("tts", "models.kokoro"),
    ("TestTrainedTts.test_synthesize_from_phonemes", "TestTrainedTts.test_output_is_tonal"),
    edits=(("from fluidaudio_tpu.train import fixtures as fx\n",
            "from fluidaudio_tpu.train import fixtures as fx\n"
            "from fluidaudio_tpu_torch.train import fixtures as port_fx\n"),
           ("fx.load_tts_manager()", 'port_fx.load_tts_manager(device="cpu")')))


@pytest.fixture(scope="module")
def manager():
    """`TestKokoroVocabScenarios.manager`: the english variant at full width,
    seeded, on the CPU."""
    return KokoroManager(device="cpu")


@pytest.mark.parametrize("case", KOKORO_CASES + CHAIN_CASES + TRAINED_CASES)
def test_jax_kokoro_case_on_the_port(case, request):
    case(request)


def test_cases_cover_the_jax_suites():
    # test_tts_kokoro.py: 26 cases (4 of them mandarin), less the real-weights roundtrip
    assert len(KOKORO_CASES) == 26 - 1
    assert sum(c.id.startswith("TestVariants.test_mandarin") for c in KOKORO_CASES) == 4
    assert [c.id for c in CHAIN_CASES] == ["test_kokoro_chain"]
    assert len(TRAINED_CASES) == 2


def test_config_fields_are_jax_s():
    assert [f.name for f in dataclasses.fields(pk.KokoroConfig)] == [
        f.name for f in dataclasses.fields(jk.KokoroConfig)]
    assert dataclasses.asdict(port_fx.kokoro_tiny_config()) == dataclasses.asdict(
        jax_fx.kokoro_tiny_config())
