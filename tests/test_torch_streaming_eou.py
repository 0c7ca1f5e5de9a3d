"""Streaming EOU ASR of the PyTorch port against the JAX manager.

On the trained `eou` fixture (`fluidaudio_tpu/assets/trained_tiny/eou`), the
port's `StreamingEouAsrManager` and the JAX one take the same utterances
(the draws of `train/fixtures.eval_eou_fixture`, 320 ms tier) and must give
the same final text, token ids, timestamps and debounced EOU flags, exactly.
Then, on the port alone: the fixture's WER and EOU gates, incremental feeding
against one shot, the EOU token kept out of the text, the debounce, the mel
frame count of each tier, state isolation and callbacks. Two pieces the
managers are built from are held against JAX on their own: the streaming mel
frontend (`center=False`, preemphasis carried by `last_samples`) and the
RNN-T decode as the managers use it (no duration bins, `eou_id` flagged,
`max_tokens` 64 and 256, state carried across chunks with `time_jump`
zeroed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidaudio_tpu.asr import streaming_eou as jax_eou
from fluidaudio_tpu.models.predictor import (
    PredictorConfig as JaxPredictorConfig,
    RnntJoint as JaxJoint,
    RnntPredictor as JaxPredictor,
)
from fluidaudio_tpu.ops import tdt_decode as jax_tdt
from fluidaudio_tpu.ops.mel import MelConfig as JaxMelConfig, MelFrontend as JaxMel
from fluidaudio_tpu.train import fixtures as fx
from fluidaudio_tpu.train import tiny_corpus as jax_tc
from fluidaudio_tpu_torch.asr import streaming_eou as port_eou
from fluidaudio_tpu_torch.metrics.wer import wer
from fluidaudio_tpu_torch.models.predictor import PredictorConfig, RnntJoint, RnntPredictor
from fluidaudio_tpu_torch.ops import tdt_decode as port_tdt
from fluidaudio_tpu_torch.ops.mel import MelConfig, MelFrontend
from fluidaudio_tpu_torch.train import tiny_corpus as tc
from fluidaudio_tpu_torch.utils.weights import from_jax_params, load_state
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

CKPT = fx.trained_assets_dir() / "eou"
WER_GATE = 0.02
TAIL = np.zeros(int(1.28 * 16_000), np.float32)  # the open-mic silence of the eval


def _utterances(seed=2468, n=6):
    """The draws of `eval_eou_fixture`: (word ids, audio with 1.28 s tail)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 8)))
        out.append((ids, np.concatenate([tc.make_utterance(ids, rs), TAIL])))
    return out


UTTS = _utterances()


def _port_manager(**kw):
    return port_eou.StreamingEouAsrManager(chunk_ms=320, spec=port_eou.EOU_TEST,
                                           checkpoint_dir=CKPT, device="cpu", **kw)


@pytest.fixture(scope="module")
def managers():
    jax_mgr = jax_eou.StreamingEouAsrManager(chunk_ms=320, spec=jax_eou.EOU_TEST,
                                             checkpoint_dir=CKPT)
    return jax_mgr, _port_manager()


def _run(mgr, audio):
    state = mgr.make_state()
    partials = mgr.process(audio, state)
    return partials, mgr.finish(state)


@pytest.mark.parametrize("u", range(len(UTTS)))
def test_trained_fixture_matches_jax(managers, u):
    ids, audio = UTTS[u]
    jax_mgr, port_mgr = managers
    jp, jf = _run(jax_mgr, audio)
    pp, pf = _run(port_mgr, audio)
    assert pf.text == jf.text == tc.transcript_text(ids)
    assert pf.token_ids == jf.token_ids
    assert pf.timestamps_ms == jf.timestamps_ms
    assert [(p.token_ids, p.timestamps_ms, p.eou_detected) for p in pp] == \
        [(p.token_ids, p.timestamps_ms, p.eou_detected) for p in jp]
    assert any(p.eou_detected for p in pp)


def test_trained_fixture_gates():
    """`eval_eou_fixture` through the port: WER <= 0.02 and the debounced
    EOU fires for every utterance."""
    events = []
    mgr = _port_manager(on_eou=events.append)
    rates, detected = [], 0
    for ids, audio in UTTS:
        events.clear()
        _, final = _run(mgr, audio)
        rates.append(wer(tc.transcript_text(ids), final.text).rate)
        detected += bool(events)
    assert np.mean(rates) <= WER_GATE
    assert detected / len(UTTS) >= 0.99


def test_incremental_feed_matches_one_shot():
    mgr = _port_manager()
    rs = np.random.RandomState(55)
    ids = rs.randint(0, tc.N_WORDS, size=5)
    audio = tc.make_utterance(ids, rs)
    _, one_shot = _run(mgr, audio)
    st = mgr.make_state()
    for off in range(0, audio.size, 1600):
        mgr.process(audio[off:off + 1600], st)
    incremental = mgr.finish(st)
    assert one_shot.text == incremental.text == tc.transcript_text(ids)
    assert one_shot.token_ids == incremental.token_ids
    assert one_shot.timestamps_ms == incremental.timestamps_ms


def test_eou_token_not_in_transcript_and_timestamps_monotone():
    mgr = _port_manager()
    rs = np.random.RandomState(56)
    ids = rs.randint(0, tc.N_WORDS, size=4)
    _, final = _run(mgr, np.concatenate([tc.make_utterance(ids, rs), TAIL]))
    assert "<eou>" not in final.text and port_eou.EOU_TEST.eou_token_id not in final.token_ids
    assert final.timestamps_ms == sorted(final.timestamps_ms)
    assert len(final.token_ids) == len(final.timestamps_ms) == 4


def test_eou_debounce():
    """A raw EOU within 1280 ms of the last accepted one is suppressed."""
    assert port_eou.EOU_DEBOUNCE_MS == jax_eou.EOU_DEBOUNCE_MS == 1280.0
    mgr = _port_manager()
    state = mgr.make_state()
    state.pending = np.zeros(10 * mgr.chunk_samples, np.float32)
    flags = [mgr._host_advance(state, [], [], True).eou_detected for _ in range(9)]
    # 320 ms chunks: accepted at 320 ms, then every 4th chunk (1280 ms later)
    assert flags == [True, False, False, False, True, False, False, False, True]


def test_chunk_tier_mel_frame_counts():
    """Every tier's window (chunk + 240 look-ahead samples) gives exactly
    chunk_samples / 160 mel frames, 8-frame-divisible for the subsampling."""
    assert port_eou.CHUNK_TIERS_MS == jax_eou.CHUNK_TIERS_MS
    mel = MelFrontend(MelConfig(center=False, normalize=None), device="cpu")
    for ms, frames in {160: 16, 320: 32, 1280: 128}.items():
        mgr = port_eou.StreamingEouAsrManager(chunk_ms=ms, spec=port_eou.EOU_TEST,
                                              checkpoint_dir=CKPT, device="cpu")
        assert mgr.mel_frames == frames and frames % 8 == 0
        out, _ = mel(torch.zeros(1, mgr._need))
        assert out.shape[2] == frames


def test_timestamp_calculation_ms():
    assert port_eou.compute_token_timestamps_ms(4, [0, 1, 3]) == [320, 400, 560]
    assert port_eou.compute_token_timestamps_ms(10, []) == []


def test_state_isolation_and_callbacks():
    seen = []
    mgr = _port_manager(on_partial=seen.append)
    rng = np.random.RandomState(1)
    a = (rng.randn(16_000) * 0.1).astype(np.float32)
    b = (rng.randn(16_000) * 0.3).astype(np.float32)
    s1, s2 = mgr.make_state(), mgr.make_state()
    n1 = len(mgr.process(a, s1))
    mgr.process(b, s2)
    solo = mgr.make_state()
    mgr.process(a, solo)
    assert s1.tokens == solo.tokens and s1.timestamps_ms == solo.timestamps_ms
    assert n1 >= 1 and len(seen) == 3 * n1
    assert all(isinstance(p, port_eou.EouPartialResult) for p in seen)


def test_bad_tier_and_default_device(monkeypatch):
    with pytest.raises(ValueError, match="chunk_ms"):
        port_eou.StreamingEouAsrManager(chunk_ms=500, spec=port_eou.EOU_TEST, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_eou.StreamingEouAsrManager(chunk_ms=320, spec=port_eou.EOU_TEST,
                                        checkpoint_dir=CKPT)


# ----------------------------------------------------------- building blocks


@pytest.mark.parametrize("chunk_ms", [160, 320, 1280])
def test_streaming_mel_matches_jax(chunk_ms):
    """center=False, normalize=None, three windows of chunk + 240 samples
    with the previous chunk's last sample carried: 2e-3 absolute, the
    frontend's tolerance in tests/test_torch_mel.py (summation order only)."""
    cfg = dict(center=False, normalize=None)
    n = chunk_ms * 16 + 240
    audio = (np.random.RandomState(chunk_ms).randn(3, n) * 0.1).astype(np.float32)
    last = np.array([0.0, 0.25, -0.5], np.float32)
    want, want_len = JaxMel(JaxMelConfig(**cfg))(jnp.asarray(audio), None, jnp.asarray(last))
    got, got_len = MelFrontend(MelConfig(**cfg), device="cpu")(
        torch.from_numpy(audio), None, torch.from_numpy(last))
    assert got.shape == want.shape == (3, 128, chunk_ms // 10)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=0)


VOCAB = 18  # EOU_TEST: words 0..15, EOU 16, blank 18 == vocab_size


@pytest.fixture(scope="module")
def decoders():
    """The JAX and port RNN-T predictor + joint on the same perturbed weights."""
    kw = dict(vocab_size=VOCAB, pred_hidden=16, n_layers=1, enc_hidden=24, joint_hidden=16,
              n_durations=0)
    jcfg = JaxPredictorConfig(**kw)
    jpred, jjoint = JaxPredictor(jcfg), JaxJoint(jcfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    h = jnp.zeros((1, 2, 16))
    rs = np.random.RandomState(4)
    perturb = lambda t: jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.3 * rs.randn(*x.shape).astype(np.float32), t)
    pp = perturb(jpred.init(k1, jnp.zeros((2,), jnp.int32), h, h))
    jp = perturb(jjoint.init(k2, jnp.zeros((2, 24)), jnp.zeros((2, 16))))
    # favour the EOU and blank logits a little so chunks see both
    jp["params"]["out"]["bias"][16] += 1.0
    jp["params"]["out"]["bias"][18] += 1.5
    tpred, tjoint = RnntPredictor(PredictorConfig(**kw)).eval(), RnntJoint(PredictorConfig(**kw))
    load_state(tpred, from_jax_params(pp))
    load_state(tjoint, from_jax_params(jp))
    pp, jp = jax.tree_util.tree_map(jnp.asarray, (pp, jp))
    return (lambda t, h, c: jpred.apply(pp, t, h, c), lambda f, g: jjoint.apply(jp, f, g),
            tpred, tjoint.eval())


@pytest.mark.parametrize("max_tokens,eou_id", [(64, 16), (256, None), (3, 16)])
def test_rnnt_decode_across_chunks_matches_jax(decoders, max_tokens, eou_id):
    """Four chunks of 7 frames, 3 rows, the state carried with time_jump
    zeroed (as `_process_one` does): tokens, times, counts, EOU flags and
    last tokens exact, the LSTM state within f32 rounding."""
    jpred, jjoint, tpred, tjoint = decoders
    kw = dict(blank_id=VOCAB, durations=(), max_symbols_per_step=10, max_tokens=max_tokens,
              eou_id=eou_id)
    jcfg, pcfg = jax_tdt.TdtDecodeConfig(**kw), port_tdt.TdtDecodeConfig(**kw)
    jstate = jax_tdt.make_initial_state(jcfg, 1, 16, 3)
    pstate = port_tdt.make_initial_state(pcfg, 1, 16, 3)
    rs = np.random.RandomState(max_tokens)
    for chunk in range(4):
        enc = rs.randn(3, 7, 24).astype(np.float32)
        lens = np.full(3, 7, np.int32)
        want = jax_tdt.tdt_greedy_decode(jcfg, jpred, jjoint, jnp.asarray(enc),
                                         jnp.asarray(lens), jstate)
        got = port_tdt.tdt_greedy_decode(pcfg, tpred, tjoint, torch.from_numpy(enc),
                                         torch.from_numpy(lens), pstate)
        counts = np.asarray(want.counts)
        np.testing.assert_array_equal(got.counts.numpy(), counts)
        for b, n in enumerate(counts):
            np.testing.assert_array_equal(got.tokens[b, :n].numpy(), np.asarray(want.tokens)[b, :n])
            np.testing.assert_array_equal(got.token_times[b, :n].numpy(),
                                          np.asarray(want.token_times)[b, :n])
        np.testing.assert_array_equal(got.eou_detected.numpy(), np.asarray(want.eou_detected))
        np.testing.assert_array_equal(got.state.last_token.numpy(),
                                      np.asarray(want.state.last_token))
        np.testing.assert_allclose(got.state.h.numpy(), np.asarray(want.state.h), atol=1e-5)
        assert eou_id is None or eou_id not in got.tokens[got.tokens != VOCAB].tolist()
        jstate = want.state._replace(time_jump=jnp.zeros_like(want.state.time_jump))
        pstate = got.state._replace(time_jump=torch.zeros_like(got.state.time_jump))


def test_tiny_corpus_language_b_is_bit_identical():
    rs_a, rs_b = np.random.RandomState(91), np.random.RandomState(91)
    ids = rs_a.randint(0, 16, size=4)
    np.testing.assert_array_equal(ids, rs_b.randint(0, 16, size=4))
    a = jax_tc.make_utterance(ids, rs_a, lang="b")
    b = tc.make_utterance(ids, rs_b, lang="b")
    assert a.tobytes() == b.tobytes()
    assert [jax_tc.word_text_b(i) for i in ids] == [tc.word_text_b(i) for i in ids]
