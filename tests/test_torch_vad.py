"""Silero VAD of the PyTorch port against the JAX package.

Per module, in f32 on the same numpy-seeded inputs with the trained `vad`
fixture's weights (`SileroV5Config()`, the real topology): `encode` (the
reflect-padded STFT-basis conv, magnitude and conv stack, <= 1e-5 abs +
1e-6 relative: the features reach ~60),
`lstm_gates` (<= 1e-5 abs), and `vad_frame_program` (frame probabilities and
the final state gathered at `last_idx`, <= 1e-5 abs), from f32 and from
int16 input, which is upcast on the device; the port's frame program equals
stepping the model frame by frame, as `tests/test_vad.py` pins it in JAX.
The whole slice: on the fixture's held-out clips both managers give chunk
probabilities within 1e-5, the same F1, the same segments, and the same
streaming events. The cases of `tests/test_vad.py` (but the one that drives
JAX directly, restated here) and `tests/test_vad_scenarios.py` run against
the port (`jax_cases`, with their fixtures).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidaudio_tpu.models import silero_vad as jax_sv
from fluidaudio_tpu.train import fixtures as jax_fx
from fluidaudio_tpu.utils.checkpoint import load_params
from fluidaudio_tpu.vad import VadManager as JaxVad
from fluidaudio_tpu.vad import VadSegmentationConfig as JaxSegConfig
from fluidaudio_tpu_torch.models import silero_vad as port_sv
from fluidaudio_tpu_torch.train import fixtures as port_fx
from fluidaudio_tpu_torch.utils import weights
from fluidaudio_tpu_torch.vad import VadManager, VadSegmentationConfig
from tests.test_torch_custom_vocab import jax_cases, jax_fixtures, one_torch_thread  # noqa: F401
from tests.test_torch_parallel import cpu_mesh_1x1  # noqa: F401

ATOL = 1e-5
CKPT = jax_fx.trained_assets_dir() / "vad"


@functools.cache
def trained():
    model = jax_sv.SileroVadV5(jax_sv.SileroV5Config())
    params = load_params(CKPT / "silero_vad.npz", model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 576)), jnp.zeros((1, 128)), jnp.zeros((1, 128))))
    port = port_sv.SileroVadV5().eval()
    weights.load_state(port, weights.load_npz(CKPT / "silero_vad.npz"))
    return model, params, port


def test_config_and_basis_layout():
    assert vars(port_sv.SileroV5Config()) == vars(jax_sv.SileroV5Config())
    _, _, port = trained()
    assert tuple(port.stft_basis.weight.shape) == (258, 1, 256)  # npz [256, 1, 258]
    assert tuple(port.enc0.weight.shape) == (128, 129, 3)


def test_encode_equals_jax():
    model, params, port = trained()
    frames = (np.random.RandomState(0).randn(37, 576) * 0.2).astype(np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(frames), method=jax_sv.SileroVadV5.encode))
    with torch.no_grad():
        got = port.encode(torch.from_numpy(frames)).numpy()
    # the features reach ~60, where one f32 ulp is 4e-6: 1e-6 relative there
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)


def test_lstm_gates_equal_jax():
    rs = np.random.RandomState(1)
    z, c = rs.randn(5, 512).astype(np.float32) * 2, rs.randn(5, 128).astype(np.float32)
    want = jax_sv.lstm_gates(jnp.asarray(z), jnp.asarray(c))
    got = port_sv.lstm_gates(torch.from_numpy(z), torch.from_numpy(c))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


@pytest.mark.parametrize("pcm", [False, True], ids=["f32", "int16"])
def test_frame_program_equals_jax(pcm):
    model, params, port = trained()
    rs = np.random.RandomState(2 + pcm)
    B, N = 3, 24
    audio = rs.randn(B, 64 + N * 512) * 0.15
    audio = np.round(audio * 32768).astype(np.int16) if pcm else audio.astype(np.float32)
    h0 = rs.randn(B, 128).astype(np.float32) * 0.1
    c0 = rs.randn(B, 128).astype(np.float32) * 0.1
    last = np.array([N - 1, 7, 0], np.int32)
    want = jax_sv.vad_frame_program(model, params, jnp.asarray(audio), jnp.asarray(h0),
                                    jnp.asarray(c0), jnp.asarray(last))
    got = port_sv.vad_frame_program(port, torch.from_numpy(audio), torch.from_numpy(h0),
                                    torch.from_numpy(c0), torch.from_numpy(last))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0)


def test_frame_program_matches_sequential():
    """`tests/test_vad.py::test_frame_program_matches_sequential` on the port:
    the batched program equals stepping the model frame by frame, and the
    state at `last_idx` equals the stepped state there."""
    _, _, port = trained()
    rs = np.random.RandomState(3)
    N, mid = 10, 4
    audio = (rs.randn(1, 64 + N * 512) * 0.1).astype(np.float32)
    zeros = torch.zeros(1, 128)
    probs, h_mid, c_mid = port_sv.vad_frame_program(
        port, torch.from_numpy(audio), zeros, zeros, torch.tensor([mid]))
    h, c = zeros, zeros
    for j in range(N):
        frame = torch.from_numpy(audio[:, j * 512 : j * 512 + 576])
        p_ref, h, c = port(frame, h, c)
        np.testing.assert_allclose(probs[0, j].item(), p_ref[0].item(), atol=ATOL)
        if j == mid:
            np.testing.assert_allclose(h_mid.numpy(), h.numpy(), atol=ATOL)
            np.testing.assert_allclose(c_mid.numpy(), c.numpy(), atol=ATOL)


@functools.cache
def managers():
    return JaxVad(checkpoint_dir=CKPT), VadManager(checkpoint_dir=CKPT, device="cpu")


def probs(results) -> np.ndarray:
    return np.array([r.probability for r in results])


def test_fixture_probabilities_f1_and_segments_equal_jax():
    jax_mgr, port_mgr = managers()
    clips = [clip for _, clip in port_fx.vad_fixture_clips()]
    for clip in clips:
        np.testing.assert_allclose(probs(port_mgr.process(clip)), probs(jax_mgr.process(clip)),
                                   atol=ATOL, rtol=0)
    for got, want in zip(port_mgr.process_batch(clips), jax_mgr.process_batch(clips)):
        np.testing.assert_allclose(probs(got), probs(want), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[-1].output_state.hidden_state,
                                   want[-1].output_state.hidden_state, atol=ATOL)
    f1 = port_fx.eval_vad_fixture(device="cpu")
    assert f1 == jax_fx.eval_vad_fixture() and f1 >= 0.9
    long = np.concatenate(clips)
    cfg = dict(min_speech_duration=0.2, min_silence_duration=0.3)
    got = port_mgr.segment_speech(long, VadSegmentationConfig(**cfg))
    want = jax_mgr.segment_speech(long, JaxSegConfig(**cfg))
    assert [vars(s) for s in got] == [vars(s) for s in want] and got


def test_streaming_events_equal_jax():
    jax_mgr, port_mgr = managers()
    audio = np.concatenate([clip for _, clip in port_fx.vad_fixture_clips(seed=31)])
    cfg = dict(min_silence_duration=0.3)
    states = [jax_mgr.make_stream_state(), port_mgr.make_stream_state()]
    events = [[], []]
    for start in range(0, audio.size, 4096):
        chunk = audio[start : start + 4096]
        for i, (mgr, seg) in enumerate(((jax_mgr, JaxSegConfig), (port_mgr,
                                                                   VadSegmentationConfig))):
            res = mgr.process_streaming_chunk(chunk, states[i], seg(**cfg),
                                              return_seconds=True)
            states[i] = res.state
            events[i].append((res.event and vars(res.event), res.probability))
    for (ev_w, p_w), (ev_g, p_g) in zip(*events):
        assert ev_g == ev_w
        assert abs(p_g - p_w) <= ATOL
    assert sum(ev is not None for ev, _ in events[1]) >= 4


def test_program_cache_keeps_the_most_recent_shapes():
    """The frame programs (CUDA graphs on the card, which hold device
    buffers) are kept per (batch, bucket, dtype) up to `PROGRAM_CACHE_SIZE`,
    least recently used out first; a shape run again after its eviction
    gives the same probabilities."""
    from fluidaudio_tpu_torch.vad import manager as port_manager

    mgr = VadManager(checkpoint_dir=CKPT, device="cpu")
    clip = port_fx.vad_fixture_clips()[0][1][:4096]
    first = [probs(r) for r in mgr.process_batch([clip])]
    limit = port_manager.PROGRAM_CACHE_SIZE
    for batch in range(2, limit + 3):
        mgr.process_batch([clip] * batch)
        assert len(mgr._program_cache) == min(batch, limit)
    assert [k[0] for k in mgr._program_cache] == list(range(3, limit + 3))
    again = [probs(r) for r in mgr.process_batch([clip])]
    np.testing.assert_array_equal(again, first)
    assert list(mgr._program_cache)[-1][0] == 1 and len(mgr._program_cache) == limit


def test_set_mesh(cpu_mesh_1x1):
    """`set_mesh(None)` keeps single-device serving; a 1 x 1 mesh runs the
    sharded batch path (padding, this rank's rows, the gather) with
    probabilities equal to the unsharded ones (the 4 x 2 mesh, with the
    batch padded from 5 to 8 rows, is in `tests/test_torch_parallel.py`)."""
    _, port_mgr = managers()
    port_mgr.set_mesh(None)
    clips = [clip for _, clip in port_fx.vad_fixture_clips()][:5]
    want = [probs(b) for b in port_mgr.process_batch(clips)]
    port_mgr.set_mesh(cpu_mesh_1x1)
    got = [probs(b) for b in port_mgr.process_batch(clips)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


VAD_EDITS = [("VadManager(VadConfig())", 'VadManager(VadConfig(), device="cpu")')]
SCENARIO_EDITS = [("return VadManager()", 'return VadManager(device="cpu")')]
globals().update(jax_fixtures("test_vad.py", edits=VAD_EDITS))
globals().update(jax_fixtures("test_vad_scenarios.py", edits=SCENARIO_EDITS))
VAD_CASES = [c for c in jax_cases("test_vad.py", edits=VAD_EDITS, fixtures=True)
             if c.id != "test_frame_program_matches_sequential"]  # drives JAX: restated above
SCENARIO_CASES = jax_cases("test_vad_scenarios.py", edits=SCENARIO_EDITS, fixtures=True)


@pytest.mark.parametrize("case", VAD_CASES)
def test_jax_vad_case_on_the_port(case, request):
    case(request)


@pytest.mark.parametrize("case", SCENARIO_CASES)
def test_jax_vad_scenario_on_the_port(case, request):
    case(request)
