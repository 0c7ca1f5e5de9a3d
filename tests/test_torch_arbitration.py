"""Dual-decode arbitration of the PyTorch port against JAX.

`arbitrate` probes three decode strategies in one batched pipeline call
(the port's `build_pipeline(4)` on the same 4 x 240,000 batch JAX builds)
and picks the most confident. On the trained `test-tiny` fixture, for a
short probe and a full 15 s one, the port picks JAX's strategy with each
strategy's confidence within 1e-5 (f32 softmax in two libraries), and the
decision applies to an `ASRConfig` as JAX's does.
"""

import pytest

from fluidaudio_tpu.asr.arbitration import arbitrate as jax_arbitrate
from fluidaudio_tpu.asr.config import ASRConfig as JaxASRConfig
from fluidaudio_tpu_torch.asr.arbitration import ArbitrationDecision, arbitrate
from fluidaudio_tpu_torch.asr.config import ASRConfig
from tests.test_torch_sliding_window import jax_asr_manager, port_asr_manager, utterance
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def managers():
    return jax_asr_manager(), port_asr_manager()


@pytest.mark.parametrize("n_words,probe_seconds", [(12, 3.0), (40, 15.0)])
def test_arbitrate_matches_jax(managers, n_words, probe_seconds):
    jax_mgr, port_mgr = managers
    _, audio = utterance(n_words, seed=n_words)
    want = jax_arbitrate(jax_mgr, audio, probe_seconds=probe_seconds)
    got = arbitrate(port_mgr, audio, probe_seconds=probe_seconds)
    assert isinstance(got, ArbitrationDecision)
    assert got.strategy == want.strategy
    assert list(got.confidences) == ["silence_aligned", "warmup", "regular"]
    for key, value in want.confidences.items():
        assert got.confidences[key] == pytest.approx(value, abs=1e-5)
    assert 0.0 < got.confidences[got.strategy] <= 1.0
    assert (got.apply(ASRConfig()).prefer_silence_alignment
            == want.apply(JaxASRConfig()).prefer_silence_alignment)


@pytest.mark.parametrize("strategy,prefer", [("regular", False), ("warmup", True),
                                             ("silence_aligned", True)])
def test_decision_applies_to_the_config(strategy, prefer):
    cfg = ArbitrationDecision(strategy, {}).apply(ASRConfig(prefer_silence_alignment=not prefer))
    assert cfg.prefer_silence_alignment is prefer
