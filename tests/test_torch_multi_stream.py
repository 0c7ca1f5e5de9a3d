"""`MultiStreamEouManager` of the PyTorch port against the JAX manager.

Both managers run the `TINY` encoder of `tests/test_multi_stream.py` with
the EOU 120M predictor and joint, on the same weights (the JAX manager's
seeded init, saved as npz and loaded by the port through `checkpoint_dir`).
Lockstep ticks, stream isolation, a stream joining late and leaving early
(ragged join/leave invariance) and slot reset give token-exact tick
outputs and transcripts against JAX, and the JAX cases' own invariants
hold. On the trained `eou` fixture (`spec=EOU_TEST`) three streams give
each stream's single-stream tokens.
"""

import numpy as np
import pytest

from fluidaudio_tpu.asr.multi_stream import MultiStreamEouManager as JaxManager
from fluidaudio_tpu.models.conformer_streaming import (
    StreamingConformerConfig as JaxStreamingConfig,
)
from fluidaudio_tpu.train.fixtures import trained_assets_dir
from fluidaudio_tpu.utils.checkpoint import save_params
from fluidaudio_tpu_torch.asr.multi_stream import MultiStreamEouManager
from fluidaudio_tpu_torch.asr.streaming_eou import EOU_TEST, StreamingEouAsrManager
from fluidaudio_tpu_torch.models.conformer_streaming import StreamingConformerConfig
from fluidaudio_tpu_torch.train import tiny_corpus as tc
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

TINY = dict(d_model=64, n_layers=2, n_heads=4, att_context_left=16, subsampling_channels=16)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX manager's seeded weights, as the npz files the port loads."""
    path = tmp_path_factory.mktemp("multi_stream_weights")
    ref = JaxManager(n_streams=1, chunk_ms=320, enc_cfg=JaxStreamingConfig(**TINY))
    for part in ("encoder", "predictor", "joint"):
        save_params(path / f"{part}.npz", ref.params[part])
    return path


def pair(weights, n):
    """A fresh JAX manager and a fresh port manager of n streams, same weights."""
    return (JaxManager(n_streams=n, chunk_ms=320, enc_cfg=JaxStreamingConfig(**TINY)),
            MultiStreamEouManager(n, 320, enc_cfg=StreamingConformerConfig(**TINY),
                                  checkpoint_dir=weights, device="cpu"))


def noise(seed, n, scale):
    return (np.random.RandomState(seed).randn(n) * scale).astype(np.float32)


def drain(m, limit=50):
    ticks = []
    while m.ready and len(ticks) < limit:
        ticks.append(m.tick())
    return ticks


def test_lockstep_ticks_match_jax(weights):
    jax_m, port_m = pair(weights, 3)
    for m in (jax_m, port_m):
        m.feed(0, noise(0, 16_000, 0.1))
        m.feed(1, noise(1, 16_000, 0.3))
    want, got = drain(jax_m), drain(port_m)
    assert got == want and len(got) >= 2
    assert all(out[2] == [] for out in got)  # a stream with no audio emits nothing
    assert any(out[0] or out[1] for out in got)  # the case emits tokens
    assert [port_m.transcript(i) for i in range(3)] == [jax_m.transcript(i) for i in range(3)]
    # isolation: more audio for stream 0 moves stream 0 only
    before = port_m.transcript(1)
    for m in (jax_m, port_m):
        m.feed(0, noise(5, 12_000, 0.1))
    assert drain(port_m) == drain(jax_m)
    assert port_m.transcript(1) == before
    assert port_m.transcript(0) == jax_m.transcript(0)


def test_tick_without_an_active_row_steps_and_changes_nothing(weights):
    """As in JAX, `tick()` steps the full static batch even when no row has a
    full chunk; every row keeps its state."""
    jax_m, port_m = pair(weights, 2)
    for m in (jax_m, port_m):
        m.feed(0, noise(2, 8_000, 0.2))
        drain(m)
        assert not m.ready
        assert m.tick() == [[], []]
        m.feed(0, noise(3, 8_000, 0.2))
    assert drain(port_m) == drain(jax_m)
    assert port_m.transcript(0) == jax_m.transcript(0)


def test_ragged_join_leave_matches_jax_and_solo(weights):
    """The JAX test's schedule: a stream that joins late (slot 1 closed, then
    opened) and is ended early gives its solo transcript, on both."""
    audio = noise(7, 24_000, 0.2)
    other = noise(8, 24_000, 0.1)
    transcripts = []
    for m in pair(weights, 2):
        m.streams[1].ended = True
        m.feed(0, other[:12_000])
        for _ in range(2):
            if m.ready:
                m.tick()
        late = m.open_stream()
        assert late == 1
        m.feed(late, audio[:8_000])
        m.feed(0, other[12_000:])
        drain(m)
        m.feed(late, audio[8_000:16_000])
        drain(m)
        m.end_stream(late)  # leaves early: the rest of its audio is never fed
        m.feed(0, other[:8_000])
        drain(m)
        transcripts.append((m.transcript(0), m.transcript(late)))
    assert transcripts[1] == transcripts[0]

    jax_solo, port_solo = pair(weights, 2)
    for m in (jax_solo, port_solo):
        m.feed(0, audio[:16_000])
        drain(m)
    assert port_solo.transcript(0) == jax_solo.transcript(0) == transcripts[1][1]


def test_close_and_reopen_resets_the_slot_as_jax(weights):
    jax_m, port_m = pair(weights, 2)
    for m in (jax_m, port_m):
        m.feed(0, noise(9, 16_000, 0.2))
        m.feed(1, noise(10, 16_000, 0.2))
        drain(m)
        m.close_stream(1)
        assert m.open_stream() == 1
        assert m.transcript(1) == ""
        with pytest.raises(RuntimeError):
            m.open_stream()  # both slots live now
        m.feed(1, noise(10, 16_000, 0.2))  # the same audio again, from a reset row
    assert drain(port_m) == drain(jax_m)
    assert port_m.transcript(1) == jax_m.transcript(1) != ""
    c, d = port_m.session.caches, port_m.session.dec_state
    port_m.close_stream(0)
    port_m.open_stream()
    assert not c.pre_cache[0].any() and not c.channel[:, 0].any() and not c.time[:, 0].any()
    assert int(c.channel_len[0]) == 0 and not d.h[:, 0].any() and not d.c[:, 0].any()
    assert int(d.last_token[0]) == port_m.dcfg.blank_id and int(d.time_jump[0]) == 0


def test_trained_fixture_streams_equal_single_stream():
    ckpt = trained_assets_dir() / "eou"
    multi = MultiStreamEouManager(3, 320, spec=EOU_TEST, checkpoint_dir=ckpt, device="cpu")
    single = StreamingEouAsrManager(320, spec=EOU_TEST, checkpoint_dir=ckpt, device="cpu")
    rs = np.random.RandomState(97)
    utts = []
    for _ in range(3):
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 8)))
        utts.append(tc.make_utterance(ids, rs))
    for i, a in enumerate(utts):
        multi.feed(i, a)
    drain(multi, limit=200)
    for i, a in enumerate(utts):
        partials = single.process(a, single.make_state())
        assert multi.streams[i].tokens == [t for p in partials for t in p.token_ids]
        assert multi.transcript(i)


def test_spec_and_a_different_enc_cfg_are_refused():
    with pytest.raises(ValueError):
        MultiStreamEouManager(1, 320, spec=EOU_TEST, device="cpu",
                              enc_cfg=StreamingConformerConfig(**TINY))
