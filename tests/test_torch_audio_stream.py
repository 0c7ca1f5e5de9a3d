"""`utils/audio_stream.py` of the PyTorch port (a host-only copy) against JAX.

Every AudioStream / AudioRingBuffer case of `tests/test_metrics_and_stream.py`
runs against the port's module (`jax_cases`), and a seeded stream of
writes with timestamp jumps gives the same chunks from both modules.
"""

import numpy as np
import pytest

from fluidaudio_tpu.utils import audio_stream as jax_stream
from fluidaudio_tpu_torch.utils import audio_stream as port_stream
from tests.test_torch_custom_vocab import jax_cases, one_torch_thread  # noqa: F401

CASES = jax_cases("test_metrics_and_stream.py", modules=("utils.audio_stream",),
                  select=("TestAudioRingBuffer", "TestAudioStream"))


@pytest.mark.parametrize("case", CASES)
def test_jax_audio_stream_case_on_the_port(case):
    case()


@pytest.mark.parametrize("strategy", ["fixed_skip", "most_recent"])
@pytest.mark.parametrize("startup", ["start_silent", "ramp_up", "wait_full"])
def test_chunks_equal_jax(strategy, startup):
    """Seeded writes of ragged sizes, with forward and backward timestamp
    jumps, read back chunk by chunk: the same chunks and times."""

    def run(mod):
        rs = np.random.RandomState(3)
        stream = mod.AudioStream(chunk_duration=0.5, chunk_skip=0.25, sample_rate=16_000,
                                 chunking_strategy=strategy, startup_strategy=startup)
        out, t = [], 0.0
        for i in range(30):
            n = int(rs.randint(100, 6000))
            jump = (0.05 if i % 7 == 3 else -0.02 if i % 11 == 5 else 0.0)
            t += jump
            stream.write(rs.randn(n).astype(np.float32), at_time=t)
            t += n / 16_000
            while (chunk := stream.read_chunk_if_available()) is not None:
                out.append(chunk)
        return out

    want, got = run(jax_stream), run(port_stream)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g[0]), np.asarray(w[0]))
        assert g[1:] == w[1:]
