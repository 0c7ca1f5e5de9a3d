"""The Parakeet TDT slice of the PyTorch port, end to end, against JAX.

The trained `test-tiny` fixture goes through the port's public entry points
(`AsrModels.load` -> `AsrManager.transcribe` / `build_pipeline`) and through
the JAX package's, on the held-out utterances of `eval_asr_fixture`
(seed 12345: 5 words in one window, 40 words chunked). The port must give
the same tokens and text as JAX, at WER <= ASR_WER_GATE.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fluidaudio_tpu.asr.config import ASRConfig as JaxASRConfig
from fluidaudio_tpu.asr.manager import AsrManager as JaxAsrManager
from fluidaudio_tpu.metrics.wer import wer
from fluidaudio_tpu.models.zoo import AsrModels as JaxAsrModels
from fluidaudio_tpu.train import tiny_corpus as jax_tc
from fluidaudio_tpu.train.fixtures import ASR_WER_GATE, trained_assets_dir
from fluidaudio_tpu_torch.asr.config import ASRConfig
from fluidaudio_tpu_torch.asr.manager import AsrManager
from fluidaudio_tpu_torch.models.zoo import AsrModels
from fluidaudio_tpu_torch.train import tiny_corpus as port_tc
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

CKPT = trained_assets_dir() / "asr"


def _utterances():
    """The exact draws of `eval_asr_fixture`: (word ids, audio) for 5 and 40."""
    rs = np.random.RandomState(12345)
    out = {}
    for n in (5, 40):
        ids = rs.randint(0, port_tc.N_WORDS, size=n)
        out[n] = (ids, port_tc.make_utterance(ids, rs))
    return out


@pytest.fixture(scope="module")
def utterances():
    return _utterances()


@pytest.fixture(scope="module")
def managers():
    jax_models = JaxAsrModels.load("test-tiny", checkpoint_dir=CKPT, allow_random_init=False)
    port_models = AsrModels.load("test-tiny", checkpoint_dir=CKPT, device="cpu",
                                 allow_random_init=False)
    return (JaxAsrManager(jax_models, JaxASRConfig(parallel_chunk_batch=2)),
            AsrManager(port_models, ASRConfig(parallel_chunk_batch=2)))


def test_tiny_corpus_copy_is_bit_identical():
    rs_a, rs_b = np.random.RandomState(12345), np.random.RandomState(12345)
    for n in (5, 40):
        ids_a = rs_a.randint(0, jax_tc.N_WORDS, size=n)
        ids_b = rs_b.randint(0, port_tc.N_WORDS, size=n)
        np.testing.assert_array_equal(ids_a, ids_b)
        a, b = jax_tc.make_utterance(ids_a, rs_a), port_tc.make_utterance(ids_b, rs_b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert jax_tc.transcript_text(ids_a) == port_tc.transcript_text(ids_b)
    assert jax_tc.tiny_vocab() == port_tc.tiny_vocab()
    for i in range(jax_tc.N_WORDS):
        assert jax_tc.word_audio(i).tobytes() == port_tc.word_audio(i).tobytes()


@pytest.mark.parametrize("n_words", [5, 40])
def test_transcribe_matches_jax_and_passes_the_wer_gate(managers, utterances, n_words):
    """5 words fit one window; 40 words (~17 s) take the chunked path with
    two windows per batch, the finalize row mask and the seam merge."""
    jax_mgr, port_mgr = managers
    ids, audio = utterances[n_words]
    want = jax_mgr.transcribe(audio)
    got = port_mgr.transcribe(audio)
    assert got.text == want.text
    assert [t.token_id for t in got.token_timings] == [t.token_id for t in want.token_timings]
    np.testing.assert_allclose([t.start_time for t in got.token_timings],
                               [t.start_time for t in want.token_timings], atol=1e-9)
    assert wer(port_tc.transcript_text(ids), got.text).rate <= ASR_WER_GATE


def test_int16_batch_pipeline_matches_jax(managers, utterances):
    """`build_pipeline(batch)` on raw int16 PCM (upcast on the device) with
    ragged rows and a finalize mask: token-exact against the JAX pipeline."""
    jax_mgr, port_mgr = managers
    W = 64_000
    rows = [utterances[5][1][:W], utterances[40][1][16_000:16_000 + 30_000]]
    audio = np.zeros((2, W), np.int16)
    lengths = np.array([len(r) for r in rows], np.int32)
    for i, r in enumerate(rows):
        audio[i, : len(r)] = np.round(np.clip(r, -1, 1) * 32767).astype(np.int16)
    finalize = np.array([True, False])
    want, want_len = jax.jit(jax_mgr.build_pipeline(2))(
        jax_mgr.models.params, jnp.asarray(audio), jnp.asarray(lengths), jnp.asarray(finalize))
    got, got_len = port_mgr.build_pipeline(2)(
        torch.from_numpy(audio), torch.from_numpy(lengths), torch.from_numpy(finalize))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    for field in ("tokens", "token_times", "counts", "durations"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_array_equal(got.state.time_jump.numpy(), np.asarray(want.state.time_jump))
    assert int(got.counts[0]) > 0


def test_carried_decoder_state_and_previous_tokens(managers, utterances):
    """Two sequential calls carrying the decoder state, the second with the
    first call's tail tokens for boundary dedup, match JAX token for token."""
    jax_mgr, port_mgr = managers
    audio = utterances[40][1]
    first, second = audio[:40_000], audio[40_000:80_000]
    w1 = jax_mgr.transcribe(first, finalize=False)
    g1 = port_mgr.transcribe(first, finalize=False)
    assert g1.text == w1.text
    prev = [t.token_id for t in g1.token_timings][-4:]
    w2 = jax_mgr.transcribe(second, decoder_state=w1.decoder_state, previous_tokens=prev)
    g2 = port_mgr.transcribe(second, decoder_state=g1.decoder_state, previous_tokens=prev)
    assert g2.text == w2.text
    assert [t.token_id for t in g2.token_timings] == [t.token_id for t in w2.token_timings]
    assert int(g2.decoder_state.last_token[0]) == int(w2.decoder_state.last_token[0])


def test_short_audio_returns_empty_and_echoes_state(managers):
    _, port_mgr = managers
    res = port_mgr.transcribe(np.zeros(100, np.float32), decoder_state="carry")
    assert res.text == "" and res.decoder_state == "carry"


def test_chunked_path_refuses_a_carried_state(managers, utterances):
    _, port_mgr = managers
    with pytest.raises(ValueError, match="decoder_state"):
        port_mgr.transcribe(utterances[40][1], decoder_state=object())


def test_entry_points_run_on_the_gpu_unless_told_otherwise(monkeypatch):
    """With no `device`, `AsrModels.load` and `MelFrontend` take the GPU; with
    none present they raise, naming device="cpu", instead of running on the
    CPU unasked."""
    from fluidaudio_tpu_torch.ops.mel import MelConfig, MelFrontend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        AsrModels.load("test-tiny", checkpoint_dir=CKPT, allow_random_init=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        AsrModels.load("test-tiny", allow_random_init=True, quantization="int8")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MelFrontend(MelConfig())
    assert MelFrontend(MelConfig(), device="cpu").device == torch.device("cpu")


def test_warmup_runs_the_long_form_pipeline_once(managers, monkeypatch):
    """`warmup()` has JAX's signature and defaults: one pipeline call at
    (`parallel_chunk_batch`, the chunk layout's window) on zeros with every
    row full length and a finalize mask of False; both can be given."""
    from fluidaudio_tpu.asr.chunk import ChunkProcessor as JaxChunkProcessor
    from fluidaudio_tpu.utils.audio_source import ArrayAudioSource as JaxArraySource

    jax_mgr, port_mgr = managers
    calls = []
    build = port_mgr.build_pipeline

    def spy(batch, language=None, stateful=False):
        fn = build(batch, language, stateful)

        def run(audio, lengths, finalize=None):
            calls.append((batch, tuple(audio.shape), bool(audio.any()), lengths.tolist(),
                          finalize.tolist()))
            return fn(audio, lengths, finalize)

        return run

    monkeypatch.setattr(port_mgr, "build_pipeline", spy)
    port_mgr.warmup()
    port_mgr.warmup(batch=3, window_samples=16_000)
    b = jax_mgr.config.parallel_chunk_batch
    w = JaxChunkProcessor(JaxArraySource(np.zeros(1, np.float32))).chunk_layout(
        jax_mgr.config.mel_chunk_context).window_samples
    assert calls == [(b, (b, w), False, [w] * b, [False] * b),
                     (3, (3, 16_000), False, [16_000] * 3, [False] * 3)]
