"""Predictor, joint and greedy TDT decode of the PyTorch port against JAX.

The JAX predictor and joint are initialised once; the port loads the same
parameters through `utils.weights.from_jax_params`. Both decoders then run
on the same numpy-seeded encoder output and must agree TOKEN-EXACTLY: tokens,
frame times, counts, durations, eou flags, last token and time_jump, with
f32 rounding tolerances only on confidences and the LSTM state. The cases
mirror `tests/test_tdt_decode.py`: ragged lengths, a finalize mask, a carried
state, a forced advance, RNN-T mode, eou_id and a synthetic language mask.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fluidaudio_tpu.models.predictor import (
    PredictorConfig as JaxPredictorConfig,
    RnntJoint as JaxJoint,
    RnntPredictor as JaxPredictor,
)
from fluidaudio_tpu.ops import tdt_decode as jax_tdt
from fluidaudio_tpu_torch.models.predictor import PredictorConfig, RnntJoint, RnntPredictor
from fluidaudio_tpu_torch.ops import tdt_decode as port
from fluidaudio_tpu_torch.utils.weights import from_jax_params, load_state
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

VOCAB = 16
PCFG = dict(vocab_size=VOCAB, pred_hidden=8, n_layers=1, enc_hidden=12, joint_hidden=8)
DCFG = dict(blank_id=VOCAB, durations=(0, 1, 2, 3, 4), max_symbols_per_step=4,
            max_tokens=64)
N_DUR = 5


@pytest.fixture(scope="module")
def models():
    jcfg = JaxPredictorConfig(**PCFG)
    jpred, jjoint = JaxPredictor(jcfg), JaxJoint(jcfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    h = jnp.zeros((1, 2, PCFG["pred_hidden"]))
    pparams = jpred.init(k1, jnp.zeros((2,), jnp.int32), h, h)
    jparams = jjoint.init(k2, jnp.zeros((2, PCFG["enc_hidden"])),
                          jnp.zeros((2, PCFG["pred_hidden"])))
    # perturb the zero-initialised biases so they are exercised too
    rs = np.random.RandomState(5)
    perturb = lambda t: jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.1 * rs.randn(*x.shape).astype(np.float32)), t)
    pparams, jparams = perturb(pparams), perturb(jparams)

    cfg = PredictorConfig(**PCFG)
    tpred, tjoint = RnntPredictor(cfg).eval(), RnntJoint(cfg).eval()
    load_state(tpred, from_jax_params(pparams))
    load_state(tjoint, from_jax_params(jparams))

    def jax_pred(tokens, h, c):
        return jpred.apply(pparams, tokens, h, c)

    def jax_joint(f, g):
        return jjoint.apply(jparams, f, g)

    return jax_pred, jax_joint, tpred, tjoint


def _never_blank_jax(dur_bin):
    def f(logits):
        logits = logits.at[:, VOCAB].set(-1e9)
        return logits.at[:, -N_DUR:].set(jnp.eye(N_DUR)[dur_bin] * 10.0)
    return f


def _never_blank_torch(dur_bin):
    def f(logits):
        logits = logits.clone()
        logits[:, VOCAB] = -1e9
        logits[:, -N_DUR:] = torch.eye(N_DUR)[dur_bin] * 10.0
        return logits
    return f


def _decode_both(models, dcfg, enc, lengths, finalize=None, allowed=None,
                 override=(None, None), states=(None, None)):
    jax_pred, jax_joint, tpred, tjoint = models
    jo, to = override
    jcfg, tcfg = jax_tdt.TdtDecodeConfig(**dcfg), port.TdtDecodeConfig(**dcfg)
    B = enc.shape[0]
    L, Hd = PCFG["n_layers"], PCFG["pred_hidden"]
    jstate = states[0] or jax_tdt.make_initial_state(jcfg, L, Hd, B)
    tstate = states[1] or port.make_initial_state(tcfg, L, Hd, B)
    want = jax_tdt.tdt_greedy_decode(
        jcfg, jax_pred, (lambda f, g: jo(jax_joint(f, g))) if jo else jax_joint,
        jnp.asarray(enc), jnp.asarray(lengths), jstate,
        allowed_mask=None if allowed is None else jnp.asarray(allowed),
        finalize_mask=None if finalize is None else jnp.asarray(finalize))
    got = port.tdt_greedy_decode(
        tcfg, tpred, (lambda f, g: to(tjoint(f, g))) if to else tjoint,
        torch.from_numpy(enc), torch.from_numpy(lengths), tstate,
        allowed_mask=None if allowed is None else torch.from_numpy(allowed),
        finalize_mask=None if finalize is None else torch.from_numpy(finalize))
    return want, got


def _assert_token_exact(want, got):
    for field in ("tokens", "token_times", "counts", "durations", "eou_detected",
                  "eou_frame"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_array_equal(got.state.last_token.numpy(),
                                  np.asarray(want.state.last_token))
    np.testing.assert_array_equal(got.state.time_jump.numpy(),
                                  np.asarray(want.state.time_jump))
    # f32 softmax / LSTM in two frameworks: rounding-level differences only
    np.testing.assert_allclose(got.confidences.numpy(), np.asarray(want.confidences),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.state.h.numpy(), np.asarray(want.state.h), atol=1e-5)
    np.testing.assert_allclose(got.state.c.numpy(), np.asarray(want.state.c), atol=1e-5)


def _enc(B, T, seed, scale=2.0):
    return (np.random.RandomState(seed).randn(B, T, PCFG["enc_hidden"]) * scale).astype(np.float32)


def test_predictor_and_joint_match_jax(models):
    jax_pred, jax_joint, tpred, tjoint = models
    rs = np.random.RandomState(0)
    tokens = np.array([VOCAB, 0, 7, 15], np.int32)  # blank/SOS embeds to zeros
    h = rs.randn(1, 4, 8).astype(np.float32)
    c = rs.randn(1, 4, 8).astype(np.float32)
    jg, jh, jc = jax_pred(jnp.asarray(tokens), jnp.asarray(h), jnp.asarray(c))
    tg, th, tc = tpred(torch.from_numpy(tokens), torch.from_numpy(h), torch.from_numpy(c))
    for a, b in ((tg, jg), (th, jh), (tc, jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    f = rs.randn(4, 12).astype(np.float32)
    np.testing.assert_allclose(
        tjoint(torch.from_numpy(f), tg).numpy(),
        np.asarray(jax_joint(jnp.asarray(f), jg)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["ragged", "finalize_mixed", "never_blank_flush",
                                  "forced_advance", "all_blank_flush"])
def test_decode_token_exact(models, case):
    B, T = 4, 24
    enc = _enc(B, T, seed=42)
    lengths = np.array([24, 15, 7, 1], np.int32)
    finalize, override = None, (None, None)
    if case == "finalize_mixed":
        finalize = np.array([True, False, True, True])
    elif case == "never_blank_flush":
        # duration bin 4: the main loop leaves quickly, the flush emits
        finalize = np.ones(B, bool)
        override = (_never_blank_jax(4), _never_blank_torch(4))
    elif case == "forced_advance":
        # duration 0 and never blank: only max_symbols_per_step moves time
        override = (_never_blank_jax(0), _never_blank_torch(0))
    elif case == "all_blank_flush":
        finalize = np.ones(B, bool)
        override = (lambda x: x.at[:, VOCAB].set(1e9),
                    lambda x: torch.cat([x[:, :VOCAB], torch.full_like(x[:, :1], 1e9),
                                         x[:, VOCAB + 1:]], dim=1))
    want, got = _decode_both(models, DCFG, enc, lengths, finalize=finalize,
                             override=override)
    _assert_token_exact(want, got)
    if case == "forced_advance":
        assert got.counts.tolist() == [min(n * 4, 64) for n in lengths.tolist()]
    if case in ("ragged", "finalize_mixed"):
        assert int(got.counts.sum()) > 0


def test_carried_state_token_exact(models):
    """Decode the first half, carry each framework's own state (pre-consumption
    h/c, last token, time_jump overshoot) into the second half."""
    B, T = 3, 20
    enc = _enc(B, T, seed=11)
    half = T // 2
    lengths = np.full((B,), half, np.int32)
    w1, g1 = _decode_both(models, DCFG, enc[:, :half].copy(), lengths)
    _assert_token_exact(w1, g1)
    w2, g2 = _decode_both(models, DCFG, enc[:, half:].copy(), lengths,
                          finalize=np.array([True, False, True]),
                          states=(w1.state, g1.state))
    _assert_token_exact(w2, g2)


def test_rnnt_mode_and_eou_token_exact(models):
    """durations=() is classic RNN-T; eou_id marks a token as end of
    utterance (treated as blank, flagged with its first frame)."""
    B, T = 3, 16
    enc = _enc(B, T, seed=1)
    lengths = np.array([16, 10, 5], np.int32)
    strip = (lambda x: x[:, :-N_DUR], lambda x: x[:, :-N_DUR])
    rnnt = dict(DCFG, durations=())
    want, got = _decode_both(models, rnnt, enc, lengths, override=strip)
    _assert_token_exact(want, got)
    # the most frequent emitted token becomes the EOU token
    toks = got.tokens.numpy()[got.tokens.numpy() != VOCAB]
    eou = int(np.bincount(toks).argmax()) if toks.size else 0
    want, got = _decode_both(models, dict(DCFG, eou_id=eou), enc, lengths,
                             finalize=np.array([True, True, False]))
    _assert_token_exact(want, got)


def test_language_mask_token_exact(models):
    """A synthetic allowed_mask forbids half the vocabulary: the rerank swaps
    in the best allowed top-K candidate identically in both decoders."""
    B, T = 3, 24
    enc = _enc(B, T, seed=3)
    lengths = np.array([24, 20, 9], np.int32)
    allowed = np.zeros(VOCAB + 1, bool)
    allowed[::2] = True
    base_w, base_g = _decode_both(models, DCFG, enc, lengths)
    want, got = _decode_both(models, DCFG, enc, lengths, allowed=allowed)
    _assert_token_exact(want, got)
    emitted = got.tokens.numpy()[got.tokens.numpy() != VOCAB]
    assert emitted.size and np.all(emitted % 2 == 0)
    # the mask changed something, so the rerank path was really exercised
    assert not np.array_equal(base_g.tokens.numpy(), got.tokens.numpy())


def test_language_filter_rerank_matches_jax():
    rs = np.random.RandomState(8)
    logits = rs.randn(6, VOCAB + 1).astype(np.float32)
    logits[0, VOCAB] = 9.0  # a blank top-1 is never replaced
    k = logits.argmax(-1).astype(np.int32)
    conf = rs.rand(6).astype(np.float32)
    allowed = rs.rand(VOCAB + 1) > 0.5
    allowed[k[1]] = False  # force at least one swap
    jk, jc = jax_tdt.language_filter_rerank(jnp.asarray(logits), jnp.asarray(k),
                                            jnp.asarray(conf), jnp.asarray(allowed), VOCAB)
    tk, tc = port.language_filter_rerank(torch.from_numpy(logits), torch.from_numpy(k),
                                         torch.from_numpy(conf), torch.from_numpy(allowed),
                                         VOCAB)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    assert int(tk[0]) == VOCAB


def test_idle_steps_are_exact_no_ops(models, monkeypatch):
    """The port checks any(active) only every few steps: steps taken after
    every row finished must change nothing. Decoding with the check every
    step and every 8 steps gives identical results."""
    _, _, tpred, tjoint = models
    enc = torch.from_numpy(_enc(3, 24, seed=4))
    lengths = torch.tensor([24, 3, 1], dtype=torch.int32)
    cfg = port.TdtDecodeConfig(**DCFG)
    runs = []
    for every in (1, port.ACTIVE_CHECK_EVERY):
        monkeypatch.setattr(port, "ACTIVE_CHECK_EVERY", every)
        state = port.make_initial_state(cfg, 1, 8, 3)
        runs.append(port.tdt_greedy_decode(cfg, tpred, tjoint, enc, lengths, state,
                                           finalize_mask=torch.ones(3, dtype=torch.bool)))
    a, b = runs
    for x, y in zip(a[:3] + a[4:], b[:3] + b[4:]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    for x, y in zip(a.state, b.state):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
