"""Multi-stream batched serving of the PyTorch port (`MultiStreamMixin`).

N streams are rows of one batched chunk step; rows without a full chunk are
masked and keep their caches and decoder state. Every stream must give
exactly what the single-stream path gives (tokens, timestamps, EOU flags,
detected language), whether the streams are fed in lockstep or at
different rates, for the trained `eou` and `nemotron` fixtures, with
per-stream language prompts and forced prefixes; and the JAX package's
multi-stream session must agree with the port's. Mesh-sharded serving
(`set_mesh`) is not ported and raises.
"""

import numpy as np
import pytest

from fluidaudio_tpu.asr import streaming_eou as jax_eou
from fluidaudio_tpu.train import fixtures as fx
from fluidaudio_tpu_torch.asr import streaming_eou as port_eou
from fluidaudio_tpu_torch.asr import streaming_nemotron as port_nem
from fluidaudio_tpu_torch.models.conformer_streaming import StreamingConformerConfig
from fluidaudio_tpu_torch.train import tiny_corpus as tc
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

TINY_NEM_ENC = StreamingConformerConfig(d_model=64, n_layers=2, n_heads=4,
                                        subsampling_channels=32, att_context_left=16)


def _eou_manager():
    return port_eou.StreamingEouAsrManager(
        chunk_ms=320, spec=port_eou.EOU_TEST, checkpoint_dir=fx.trained_assets_dir() / "eou",
        device="cpu")


def _nemotron_manager():
    return port_nem.StreamingNemotronAsrManager(
        port_nem.NEMOTRON_TEST, 560, language="auto", enc_cfg=TINY_NEM_ENC,
        checkpoint_dir=fx.trained_assets_dir() / "nemotron", device="cpu")


def _eou_utterances(n, seed):
    rs = np.random.RandomState(seed)
    tail = np.zeros(int(1.28 * 16_000), np.float32)
    utts, refs = [], []
    for _ in range(n):
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 8)))
        utts.append(np.concatenate([tc.make_utterance(ids, rs), tail]))
        refs.append(tc.transcript_text(ids))
    return utts, refs


def _nemotron_utterances(langs, seed):
    rs = np.random.RandomState(seed)
    utts, refs = [], []
    for lang in langs:
        corpus = "b" if lang == "bb-BB" else "a"
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 6)))
        utts.append(tc.make_utterance(ids, rs, lang=corpus))
        refs.append(" ".join(tc.word_text(i) if corpus == "a" else tc.word_text_b(i)
                             for i in ids))
    return utts, refs


def _single(mgr, utts, langs=None, prefixes=None):
    """Each utterance through the single-stream path -> (finals, partials, states)."""
    finals, partials, states = [], [], []
    for i, a in enumerate(utts):
        if langs is not None:
            mgr.set_language(langs[i])
        state = (mgr.make_state(forced_prefix=prefixes[i]) if prefixes is not None
                 else mgr.make_state())
        partials.append(mgr.process(a, state))
        finals.append(mgr.finish(state))
        states.append(state)
    return finals, partials, states


def _staggered(mgr, session, utts, steps):
    """Drip-feed unequal slice sizes so the active masks differ per tick."""
    offsets = [0] * len(utts)
    partials = [[] for _ in utts]
    while any(o < len(a) for o, a in zip(offsets, utts)):
        feed = []
        for i, a in enumerate(utts):
            feed.append(a[offsets[i]:offsets[i] + steps[i]] if offsets[i] < len(a) else None)
            offsets[i] += steps[i]
        for i, p in enumerate(mgr.process_multi(session, feed)):
            partials[i].extend(p)
    return partials


def _same(finals, ref_finals):
    for f, r in zip(finals, ref_finals):
        assert f.text == r.text
        assert f.token_ids == r.token_ids
        assert f.timestamps_ms == r.timestamps_ms


@pytest.mark.parametrize("feed", ["lockstep", "staggered"])
def test_eou_multi_equals_single(feed):
    utts, refs = _eou_utterances(3, seed=2468 if feed == "lockstep" else 97)
    mgr = _eou_manager()
    ref_finals, ref_partials, _ = _single(mgr, utts)
    session = mgr.make_multi_state(3)
    if feed == "lockstep":
        partials = mgr.process_multi(session, utts)
    else:
        partials = _staggered(mgr, session, utts, [7000, 3000, 12000])
    finals = mgr.flush_multi(session)
    _same(finals, ref_finals)
    assert [f.text for f in finals] == refs
    for i in range(3):
        assert [p.eou_detected for p in partials[i]] == [p.eou_detected for p in ref_partials[i]]
        assert [p.token_ids for p in partials[i]] == [p.token_ids for p in ref_partials[i]]
        assert sum(p.eou_detected for p in partials[i]) >= 1


def test_eou_multi_session_matches_jax():
    """The JAX package's own multi-stream session on the same three
    streams gives the port's finals."""
    utts, _ = _eou_utterances(3, seed=31)
    jax_mgr = jax_eou.StreamingEouAsrManager(chunk_ms=320, spec=jax_eou.EOU_TEST,
                                             checkpoint_dir=fx.trained_assets_dir() / "eou")
    js = jax_mgr.make_multi_state(3)
    jax_mgr.process_multi(js, utts)
    mgr = _eou_manager()
    ps = mgr.make_multi_state(3)
    mgr.process_multi(ps, utts)
    _same(mgr.flush_multi(ps), jax_mgr.flush_multi(js))


@pytest.mark.parametrize("feed", ["lockstep", "staggered"])
def test_nemotron_per_stream_prompts_equal_single(feed):
    """Each row runs its own language prompt; the auto row detects its
    language on its own stream state."""
    langs = ["aa-AA", "bb-BB", "auto", "aa-AA"]
    utts, refs = _nemotron_utterances(langs, seed=5151 if feed == "lockstep" else 808)
    mgr = _nemotron_manager()
    ref_finals, _, ref_states = _single(mgr, utts, langs)
    session = mgr.make_multi_state(4, languages=langs)
    assert session.prompt_ids.tolist() == [1, 2, 0, 1]
    if feed == "lockstep":
        mgr.process_multi(session, utts)
    else:
        _staggered(mgr, session, utts, [9000, 4000, 13000, 6000])
    finals = mgr.flush_multi(session)
    _same(finals, ref_finals)
    for i in (0, 1, 3):
        assert finals[i].text == refs[i]
    assert session.streams[2].detected_language == ref_states[2].detected_language == "aa-AA"


def test_nemotron_forced_prefix_per_stream():
    langs = ["auto", "auto"]
    utts, refs = _nemotron_utterances(["bb-BB", "aa-AA"], seed=91)
    mgr = _nemotron_manager()
    tag = mgr.lang_tag_token("bb-BB")
    ref_finals, _, _ = _single(mgr, utts, langs, prefixes=[tag, None])
    session = mgr.make_multi_state(2, languages=langs, forced_prefix=[tag, None])
    mgr.process_multi(session, utts)
    finals = mgr.flush_multi(session)
    _same(finals, ref_finals)
    assert finals[0].text == refs[0]


def test_flush_subset_and_bad_feed():
    utts, _ = _eou_utterances(2, seed=5)
    mgr = _eou_manager()
    session = mgr.make_multi_state(2)
    mgr.process_multi(session, [utts[0], utts[1][:3000]])
    before = session.streams[0].pending.size
    finals = mgr.flush_multi(session, streams=[1])
    assert len(finals) == 1 and session.streams[1].pending.size < mgr._need
    assert session.streams[0].pending.size == before  # stream 0 untouched
    with pytest.raises(ValueError, match="expected 2"):
        mgr.process_multi(session, [utts[0]])


@pytest.mark.parametrize("make", [_eou_manager, _nemotron_manager], ids=["eou", "nemotron"])
def test_set_mesh_is_not_ported(make):
    with pytest.raises(NotImplementedError, match="torch.distributed is not ported yet"):
        make().set_mesh(object())
