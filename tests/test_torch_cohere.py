"""Cohere ASR of the PyTorch port against the JAX package.

Per module, in f32 on the same numpy-seeded inputs: the encoder at the
trained `cohere` fixture's size (Dh 8: the plain attention, <= 1e-5
relative L2), one decoder step against the JAX step (logits and the written
cache rows <= 1e-5 relative L2, at several positions with padded encoder
frames), and `cohere_greedy_decode` (token ids and counts exact) over the
trained decoder, over jittered random weights at `COHERE_TEST` where the
repetition penalty and the n-gram ban fire, and over scripted steps: EOS,
an n-gram loop, and a batch whose rows stop at different steps or run to
position M-1 (the loop stops when ANY row gets there). The loop reads its
stopping rule on the host once per 8 steps. The whole slice: both pipelines
give identical texts and WER on the held-out utterances of
`eval_cohere_fixture` and on a five-window long-form input. The JAX cases of
`tests/test_cohere.py` that use no JAX array API run against the port
(`jax_cases`).
"""

from __future__ import annotations

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidaudio_tpu.asr.cohere_manager import CoherePipeline as JaxCohere
from fluidaudio_tpu.models import cohere_asr as jax_co
from fluidaudio_tpu.train import fixtures as jax_fx
from fluidaudio_tpu.utils.checkpoint import load_params
from fluidaudio_tpu_torch.asr.cohere_manager import CoherePipeline
from fluidaudio_tpu_torch.models import cohere_asr as port_co
from fluidaudio_tpu_torch.train import fixtures as port_fx
from fluidaudio_tpu_torch.train import tiny_corpus as tc
from fluidaudio_tpu_torch.utils import weights
from tests.test_torch_custom_vocab import jax_cases, jax_fixtures, one_torch_thread  # noqa: F401
from tests.test_torch_sensevoice import REL_L2, held_out, jitter, rel_l2, to_port

JAX_CFG = jax_fx.cohere_tiny_config()
PORT_CFG = port_fx.cohere_tiny_config()


def test_configs_equal_jax():
    for name in ("COHERE_BASE", "COHERE_TEST"):
        assert vars(getattr(port_co, name)) == vars(getattr(jax_co, name))
    assert vars(PORT_CFG) == vars(JAX_CFG)
    assert port_co.COHERE_LANGUAGES == jax_co.COHERE_LANGUAGES
    base = port_co.COHERE_BASE.conformer()
    assert (base.d_model, base.n_layers, base.head_dim, base.subsampling_channels) == \
        (1280, 48, 160, 160)


@functools.cache
def trained():
    """JAX (encoder, decoder, their params) and the port's, on the fixture."""
    ckpt = jax_fx.trained_assets_dir() / "cohere"
    cfg = JAX_CFG
    enc, dec = jax_co.CohereEncoder(cfg), jax_co.CohereDecoderStep(cfg)
    mel0 = jnp.zeros((1, cfg.n_mels, 32))
    ep = load_params(ckpt / "encoder.npz", enc.init(jax.random.PRNGKey(0), mel0,
                                                     jnp.array([32], jnp.int32)))
    e0, m0 = enc.apply(ep, mel0, jnp.array([32], jnp.int32))
    L, M, H, Dh = cfg.n_decoder_layers, cfg.max_decode_tokens, cfg.n_heads, cfg.head_dim
    k0 = jnp.zeros((L, 1, M, H, Dh))
    dp = load_params(ckpt / "decoder.npz", dec.init(
        jax.random.PRNGKey(1), jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
        k0, k0, e0, m0))
    port_enc = port_co.CohereEncoder(PORT_CFG).eval()
    port_dec = port_co.CohereDecoderStep(PORT_CFG).eval()
    weights.load_state(port_enc, weights.load_npz(ckpt / "encoder.npz"))
    weights.load_state(port_dec, weights.load_npz(ckpt / "decoder.npz"))
    return enc, ep, dec, dp, port_enc, port_dec


def encoder_pair(seed: int):
    """Both encoders' outputs on one seeded mel batch (row 1 padded)."""
    enc, ep, _, _, port_enc, _ = trained()
    rs = np.random.RandomState(seed)
    mel = rs.randn(2, JAX_CFG.n_mels, 200).astype(np.float32)
    mlen = np.array([200, 120], np.int32)
    want, want_mask = enc.apply(ep, jnp.asarray(mel), jnp.asarray(mlen))
    got, got_mask = port_enc(torch.from_numpy(mel), torch.from_numpy(mlen))
    return np.array(want), np.array(want_mask), got, got_mask


@pytest.mark.parametrize("seed", [0, 1])
def test_trained_encoder_equals_jax(seed):
    want, want_mask, got, got_mask = encoder_pair(seed)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    assert got.dtype == torch.float32
    assert rel_l2(got.numpy(), want) <= REL_L2


@pytest.mark.parametrize("positions", [(0, 0), (3, 7), (15, 2)])
def test_trained_decoder_step_equals_jax(positions):
    _, _, dec, dp, _, port_dec = trained()
    want_enc, mask, enc_t, _ = encoder_pair(7)
    cfg = JAX_CFG
    rs = np.random.RandomState(sum(positions))
    L, M, H, Dh = cfg.n_decoder_layers, cfg.max_decode_tokens, cfg.n_heads, cfg.head_dim
    k = rs.randn(L, 2, M, H, Dh).astype(np.float32)
    v = rs.randn(L, 2, M, H, Dh).astype(np.float32)
    token = rs.randint(0, cfg.vocab_size, size=2).astype(np.int32)
    pos = np.asarray(positions, np.int32)
    want_logits, want_k, want_v = dec.apply(dp, jnp.asarray(token), jnp.asarray(pos),
                                            jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(want_enc), jnp.asarray(mask))
    got_logits, got_k, got_v = port_dec(
        torch.from_numpy(token), torch.from_numpy(pos), torch.from_numpy(k.copy()),
        torch.from_numpy(v.copy()), torch.from_numpy(want_enc), torch.from_numpy(mask))
    assert rel_l2(got_logits.numpy(), np.asarray(want_logits)) <= REL_L2
    assert rel_l2(got_k.numpy(), np.asarray(want_k)) <= REL_L2
    assert rel_l2(got_v.numpy(), np.asarray(want_v)) <= REL_L2
    assert (got_logits.numpy().argmax(-1) == np.asarray(want_logits).argmax(-1)).all()


def decode_both(cfg_jax, jax_step, port_step, enc, mask, **kw):
    want = jax_co.cohere_greedy_decode(cfg_jax, jax_step, jnp.asarray(enc), jnp.asarray(mask))
    got = port_co.cohere_greedy_decode(replace(port_co.COHERE_TEST, **vars(cfg_jax)), port_step,
                                       torch.from_numpy(enc), torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert got.host_syncs <= got.steps // 8 + 1
    return got


def test_trained_greedy_decode_equals_jax():
    _, _, dec, dp, _, port_dec = trained()
    want_enc, mask, _, _ = encoder_pair(3)
    got = decode_both(JAX_CFG, lambda *a: dec.apply(dp, *a), port_dec, want_enc, mask)
    assert got.steps <= JAX_CFG.max_decode_tokens - 1


@pytest.mark.parametrize("seed,enc_hidden", [(0, 32), (1, 32), (2, 48)])
def test_random_weights_greedy_decode_equals_jax(seed, enc_hidden):
    """Jittered random weights at COHERE_TEST (M 16): rows loop on a few
    tokens, so the repetition penalty and the 3-gram ban both fire. With
    `enc_hidden` 48 the encoder is wider than the decoder (as at full width:
    1280 against 1024), so the cross-attention k/v project 48 -> 32."""
    cfg = replace(jax_co.COHERE_TEST, enc_hidden=enc_hidden)
    rs = np.random.RandomState(seed)
    enc = rs.randn(3, 9, cfg.enc_hidden).astype(np.float32)
    mask = np.arange(9)[None, :] < np.array([9, 5, 1])[:, None]
    L, M, H, Dh = cfg.n_decoder_layers, cfg.max_decode_tokens, cfg.n_heads, cfg.head_dim
    dec = jax_co.CohereDecoderStep(cfg)
    k0 = jnp.zeros((L, 3, M, H, Dh))
    params = jitter(dec.init(jax.random.PRNGKey(seed), jnp.zeros((3,), jnp.int32),
                             jnp.zeros((3,), jnp.int32), k0, k0, jnp.asarray(enc),
                             jnp.asarray(mask)), seed, scale=0.5)
    port_dec = to_port(port_co.CohereDecoderStep(
        replace(port_co.COHERE_TEST, enc_hidden=enc_hidden)), params)
    decode_both(cfg, lambda *a: dec.apply(params, *a), port_dec, enc, mask)


def scripted(preferred, fallback=None, eos=2, V=8):
    """A step whose logits prefer token `preferred(pos, xp)` per row (xp:
    jnp or torch), with EOS at `fallback` when given."""
    def jax_step(token, pos, k, v, e, m):
        logits = jnp.full((pos.shape[0], V), -10.0)
        logits = logits.at[jnp.arange(pos.shape[0]), preferred(pos, jnp)].set(10.0)
        if fallback is not None:
            logits = logits.at[:, eos].set(fallback)
        return logits, k, v

    def port_step(token, pos, k, v, e, m):
        logits = torch.full((pos.shape[0], V), -10.0)
        logits[torch.arange(pos.shape[0]), preferred(pos, torch).long()] = 10.0
        if fallback is not None:
            logits[:, eos] = fallback
        return logits, k, v

    return jax_step, port_step


TOY = dict(vocab_size=8, d_model=8, n_heads=2, n_decoder_layers=1, n_encoder_layers=1,
           n_mels=4, max_decode_tokens=12, dtype="float32", bos_id=1, eos_id=2)
STOP_AT = np.array([2, 5, 8], np.int32)  # row b emits EOS at position STOP_AT[b]
ROW_TOKEN = np.array([2, 6, 7], np.int32)  # row 0 emits EOS at once, the others never


@pytest.mark.parametrize("case", ["stops_at_eos", "ngram_ban", "rows_stop_apart",
                                  "runs_to_m_minus_1", "penalty"])
def test_scripted_decode_equals_jax(case):
    """The JAX tests' scripted steps (`test_decode_stops_at_eos`,
    `test_no_repeat_ngram_bans_loop`) and batches whose rows end apart."""
    enc, mask = np.zeros((3, 4, 8), np.float32), np.ones((3, 4), bool)
    plain = jax_co.CohereConfig(**TOY, no_repeat_ngram=0, repetition_penalty=1.0)
    if case == "stops_at_eos":
        cfg, steps = plain, scripted(lambda p, xp: xp.where(p < 3, 5, 2))
    elif case == "ngram_ban":
        cfg = jax_co.CohereConfig(**TOY, no_repeat_ngram=2, repetition_penalty=1.0)
        steps = scripted(lambda p, xp: xp.where(p % 2 == 0, 3, 4), fallback=5.0)
    elif case == "rows_stop_apart":
        cfg = plain
        steps = scripted(lambda p, xp: xp.where(p < xp.asarray(STOP_AT), 6, 2))
    elif case == "runs_to_m_minus_1":
        cfg = plain
        steps = scripted(lambda p, xp: xp.asarray(ROW_TOKEN) + 0 * p)
    else:  # penalty: token 6 wins once, then its penalised logit loses to EOS
        cfg = jax_co.CohereConfig(**TOY, no_repeat_ngram=0, repetition_penalty=1.3)
        steps = scripted(lambda p, xp: 6 + 0 * p, fallback=9.0)
    got = decode_both(cfg, *steps, enc, mask)
    if case == "stops_at_eos":
        assert [int(t) for t in got.tokens[0, : int(got.counts[0])]] == [5, 5, 5, 2]
    if case == "runs_to_m_minus_1":
        assert int(got.counts.max()) == cfg.max_decode_tokens - 1


@functools.cache
def pipelines():
    ckpt = jax_fx.trained_assets_dir() / "cohere"
    return (JaxCohere(JAX_CFG, checkpoint_dir=ckpt),
            CoherePipeline(PORT_CFG, checkpoint_dir=ckpt, device="cpu"))


def test_trained_pipeline_texts_equal_jax():
    jax_mgr, port_mgr = pipelines()
    for _, audio in held_out(987, 6, max_words=8):
        assert port_mgr.transcribe(audio).text == jax_mgr.transcribe(audio).text
        for window in port_mgr.window_decodes:
            assert window.host_syncs <= window.steps // 8 + 1
    wer = port_fx.eval_cohere_fixture(device="cpu")
    assert wer == jax_fx.eval_cohere_fixture()
    assert wer <= 0.05


def test_long_form_equals_jax():
    """5.5 s at the fixture's 5.11 s cap (hop 0.11 s): five overlapping
    windows, decoded as one batch, merged at their seams."""
    jax_mgr, port_mgr = pipelines()
    rs = np.random.RandomState(5)
    audio = tc.make_utterance(rs.randint(0, tc.N_WORDS, size=14), rs)[:88_000]
    assert audio.size == 88_000
    got = port_mgr.transcribe(audio).text
    assert got == jax_mgr.transcribe(audio).text and got
    assert port_mgr.window_count == 5 and len(port_mgr.window_decodes) == 1


EDITS = [("CoherePipeline(COHERE_TEST)", 'CoherePipeline(COHERE_TEST, device="cpu")')]
globals().update(jax_fixtures("test_cohere.py", edits=EDITS))
CASES = jax_cases("test_cohere.py", edits=EDITS, fixtures=True,
                  select=("test_transcribe_smoke", "TestLongFormMerge", "TestCohereConfig"))


@pytest.mark.parametrize("case", CASES)
def test_jax_cohere_case_on_the_port(case, request):
    case(request)
