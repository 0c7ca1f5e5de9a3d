"""Unified ASR facades of the PyTorch port (`asr/unified.py`) against JAX.

The window bookkeeping (`UnifiedStreamingWindower`, `UnifiedBatchLayout`,
`UnifiedWindowConfig`) is a copy: every case of
`tests/test_unified_windowing.py` runs against the port's classes
(`jax_cases`). Both facades run on the trained `test-tiny` fixture beside
the JAX facades: `UnifiedAsrManager.transcribe` gives the same tokens and
text, and `StreamingUnifiedAsrManager` the same updates, finish and drained
timings. With no models and no device the facades load v3 on the GPU, so
without one they raise.
"""

import pytest
import torch

from fluidaudio_tpu.asr.unified import (
    StreamingUnifiedAsrManager as JaxStreamingUnified,
    UnifiedAsrManager as JaxUnified,
    UnifiedStreamingConfig as JaxUnifiedStreamingConfig,
)
from fluidaudio_tpu.models.zoo import AsrModels as JaxAsrModels
from fluidaudio_tpu_torch.asr.unified import (
    StreamingUnifiedAsrManager,
    UnifiedAsrManager,
    UnifiedStreamingConfig,
)
from fluidaudio_tpu_torch.models.zoo import AsrModels
from tests.test_torch_custom_vocab import jax_cases, one_torch_thread  # noqa: F401
from tests.test_torch_sliding_window import CKPT, assert_same_stream, stream, utterance

STREAMING = dict(chunk_seconds=2.0, left_context_seconds=3.0, right_context_seconds=1.0)


@pytest.mark.parametrize("case", jax_cases("test_unified_windowing.py",
                                           modules=("asr.unified",)))
def test_jax_windowing_case_on_the_port(case):
    case()


@pytest.fixture(scope="module")
def models():
    return (JaxAsrModels.load("test-tiny", checkpoint_dir=CKPT, allow_random_init=False),
            AsrModels.load("test-tiny", checkpoint_dir=CKPT, device="cpu",
                           allow_random_init=False))


@pytest.mark.parametrize("n_words", [8, 40])
def test_batch_facade_matches_jax(models, n_words):
    """One window (8 words) and the chunked long-form path (40 words)."""
    jax_models, port_models = models
    _, audio = utterance(n_words, seed=100 + n_words)
    want = JaxUnified(jax_models).transcribe(audio, 16_000)
    got = UnifiedAsrManager(port_models).transcribe(audio, 16_000)
    assert got.text == want.text and got.text
    assert ([t.token_id for t in got.token_timings]
            == [t.token_id for t in want.token_timings])
    assert ([t.start_time for t in got.token_timings]
            == [t.start_time for t in want.token_timings])


def test_streaming_facade_matches_jax(models):
    jax_models, port_models = models
    _, audio = utterance(24, seed=7)
    want = stream(JaxStreamingUnified(jax_models, JaxUnifiedStreamingConfig(**STREAMING)),
                  audio, 5)
    got = stream(StreamingUnifiedAsrManager(port_models, UnifiedStreamingConfig(**STREAMING)),
                 audio, 5)
    assert_same_stream(got, want)
    assert got[1]["confirmed_text"]


@pytest.mark.parametrize("facade", [UnifiedAsrManager, StreamingUnifiedAsrManager])
def test_facades_default_to_the_gpu(facade, monkeypatch):
    """With no models and no device the facades load v3 on the GPU: without
    one (simulated where there is one), they raise naming device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        facade()
