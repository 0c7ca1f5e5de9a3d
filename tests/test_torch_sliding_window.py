"""`SlidingWindowAsrManager` of the PyTorch port against the JAX manager.

Both run over their package's `AsrManager` on the trained `test-tiny`
fixture (f32). A tiny-corpus utterance is fed in ragged pieces; every
update (confirmed text, volatile text, final flag), the finish, the drained
token timings (absolute seconds) and the drained word timings must equal
JAX's, token for token (confidences within 1e-5: f32 softmax in two
libraries). Then the config-validation and reset cases of
`tests/test_sliding_window.py` run against the port (`jax_cases`), with the
manager built on the CPU.
"""

import logging

import numpy as np
import pytest

from fluidaudio_tpu.asr.config import ASRConfig as JaxASRConfig
from fluidaudio_tpu.asr.manager import AsrManager as JaxAsrManager
from fluidaudio_tpu.asr.sliding_window import (
    SlidingWindowAsrConfig as JaxSlidingConfig,
    SlidingWindowAsrManager as JaxSliding,
)
from fluidaudio_tpu.models.zoo import AsrModels as JaxAsrModels
from fluidaudio_tpu.train.fixtures import trained_assets_dir
from fluidaudio_tpu_torch.asr.config import ASRConfig
from fluidaudio_tpu_torch.asr.manager import AsrManager
from fluidaudio_tpu_torch.asr.sliding_window import (
    SlidingWindowAsrConfig,
    SlidingWindowAsrManager,
)
from fluidaudio_tpu_torch.asr.sliding_window import logger as sliding_logger
from fluidaudio_tpu_torch.models.zoo import AsrModels
from fluidaudio_tpu_torch.train import tiny_corpus as tc
from tests.test_torch_custom_vocab import jax_cases, one_torch_thread  # noqa: F401

CKPT = trained_assets_dir() / "asr"
WINDOW = dict(chunk_seconds=2.0, left_context_seconds=3.0, right_context_seconds=1.0)


def jax_asr_manager():
    models = JaxAsrModels.load("test-tiny", checkpoint_dir=CKPT, allow_random_init=False)
    return JaxAsrManager(models, JaxASRConfig(parallel_chunk_batch=2))


def port_asr_manager():
    models = AsrModels.load("test-tiny", checkpoint_dir=CKPT, device="cpu",
                            allow_random_init=False)
    return AsrManager(models, ASRConfig(parallel_chunk_batch=2))


def utterance(n_words: int, seed: int):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, tc.N_WORDS, size=n_words)
    return ids, tc.make_utterance(ids, rs)


def stream(sliding, audio, pieces: int):
    """Feed in `pieces` ragged pieces, draining token timings after every
    feed and word timings at the end -> everything observable."""
    session = sliding.make_session()
    updates, drains = [], []
    for piece in np.array_split(audio, pieces):
        updates += [vars(u) for u in sliding.feed(piece, session)]
        drains.append(sliding.consume_token_timings(session))
    final = vars(sliding.finish(session))
    words = sliding.consume_word_timings(session)
    return updates, final, drains, words, session.error_count


def assert_same_stream(got, want):
    g_updates, g_final, g_drains, g_words, g_errors = got
    w_updates, w_final, w_drains, w_words, w_errors = want
    assert g_updates == w_updates and g_final == w_final
    assert g_errors == w_errors == 0
    assert len(g_drains) == len(w_drains)
    for g, w in zip(g_drains + [g_words], w_drains + [w_words]):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            fields_a, fields_b = dict(vars(a)), dict(vars(b))
            assert fields_a.pop("confidence", 0.0) == pytest.approx(
                fields_b.pop("confidence", 0.0), abs=1e-5)
            assert fields_a == fields_b


@pytest.fixture(scope="module")
def managers():
    return jax_asr_manager(), port_asr_manager()


@pytest.mark.parametrize("n_words,pieces", [(20, 7), (34, 3)])
def test_stream_matches_jax(managers, n_words, pieces):
    jax_mgr, port_mgr = managers
    _, audio = utterance(n_words, seed=n_words)
    want = stream(JaxSliding(jax_mgr, JaxSlidingConfig(**WINDOW)), audio, pieces)
    got = stream(SlidingWindowAsrManager(port_mgr, SlidingWindowAsrConfig(**WINDOW)),
                 audio, pieces)
    assert_same_stream(got, want)
    assert got[0] and got[1]["confirmed_text"]


def test_window_errors_are_counted_and_logged(managers, monkeypatch):
    """A failing window is absorbed as in JAX: counted and logged with its
    traceback, and the stream goes on."""
    _, port_mgr = managers
    sliding = SlidingWindowAsrManager(port_mgr, SlidingWindowAsrConfig(**WINDOW))
    session = sliding.make_session()
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    sliding_logger.addHandler(handler)

    def fail(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(port_mgr, "transcribe", fail)
    try:
        updates = sliding.feed(utterance(10, seed=3)[1], session)
    finally:
        sliding_logger.removeHandler(handler)
    assert updates and session.error_count == len(updates)
    assert len(records) == len(updates)
    assert all(r.exc_info and "boom" in str(r.exc_info[1]) for r in records)


CASES = jax_cases("test_sliding_window.py", select=("TestConfigValidation",))


@pytest.mark.parametrize("case", CASES)
def test_jax_config_case_on_the_port(case, monkeypatch):
    # the JAX case builds AsrModels.load("test-tiny") with no device: on the
    # CPU here
    real = AsrModels.load.__func__
    monkeypatch.setattr(AsrModels, "load", classmethod(
        lambda cls, *a, **k: real(cls, *a, **{"device": "cpu", **k})))
    case()


def test_reset_clears_session(managers):
    _, port_mgr = managers
    sliding = SlidingWindowAsrManager(port_mgr, SlidingWindowAsrConfig(**WINDOW))
    session = sliding.make_session()
    sliding.feed(utterance(12, seed=2)[1], session)
    assert session.confirmed
    sliding.reset(session)
    assert session.buffer.size == 0 and session.consumed == 0 and session.base == 0
    assert session.confirmed == [] and session.volatile == []
    assert session.pending_timings == [] and session.volatile_timings == []
    final = sliding.finish(session)
    assert final.is_final and final.confirmed_text == ""
