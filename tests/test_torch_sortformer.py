"""Sortformer of the PyTorch port against JAX.

The same seeded inputs go through `fluidaudio_tpu.models.sortformer` and
the port's `models/sortformer.py`, on the trained `sortformer` fixture's
weights (SORTFORMER_TEST: Dh 8, the plain attention) and on a mid-width
config with seeded weights whose encoder has Dh 64, the head width
SORTFORMER_V2 gives the attention kernel:

- `encode_frames`, `predict` (a fully masked row included: uniform, not
  NaN), one `streaming_step`, and a scan of 10 chunks with every state
  field: within ATOL;
- the cache compression's top-k on tied scores (a zeroed head makes every
  valid score equal, and the invalid slots all tie at -1.0): the same slots
  as `jax.lax.top_k`, which breaks ties toward the lower index;
- `SortformerDiarizer.process_offline` and `process` on the trained fixture:
  segments equal to the JAX manager's, DER within the gate;
- the cases of `tests/test_sortformer.py` and the Sortformer half of
  `tests/test_speaker_enrollment.py` on the port (`jax_cases`). The two
  cases that call JAX's jitted programs (`_stream_scan`, `_offline_fused`)
  are restated here against the port's `stream_program` and
  `offline_windows`. The enrollment cases build SORTFORMER_V2 in JAX with
  seeded random weights; they test session and naming mechanics, so here
  they run at SORTFORMER_TEST, also with seeded random weights (the full
  width runs on the card, `chip_smoke.py` phase 16).

ATOL = 1e-5 on f32 activations and sigmoid predictions (reductions in
another order; the trained fixture's chains of 10 chunks stay within it).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidaudio_tpu.diarizer.sortformer import SortformerDiarizer as JaxDiarizer
from fluidaudio_tpu.models import sortformer as jax_sf
from fluidaudio_tpu.train import fixtures as jax_fixtures
from fluidaudio_tpu.train import tiny_corpus as jax_tc
from fluidaudio_tpu.utils.checkpoint import load_params
from fluidaudio_tpu_torch.diarizer.sortformer import OFFLINE_WINDOW_MEL
from fluidaudio_tpu_torch.diarizer.sortformer import SortformerDiarizer as PortDiarizer
from fluidaudio_tpu_torch.models import sortformer as port_sf
from fluidaudio_tpu_torch.train import fixtures as port_fixtures
from fluidaudio_tpu_torch.utils.weights import from_jax_params, load_state
from tests.test_torch_custom_vocab import jax_cases, jax_fixtures as jax_test_fixtures
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

ATOL = 1e-5
CKPT = jax_fixtures.trained_assets_dir() / "sortformer"
# a mid-width config whose encoder has Dh 64 (SORTFORMER_V2's head width)
MID = dict(n_mels=32, d_model=64, encoder_d_model=128, n_encoder_layers=2,
           n_transformer_layers=2, n_heads=2, spkcache_len=16, fifo_len=8,
           chunk_frames=4, update_period=4)


def _pair(name: str):
    """(JAX model, its params, port model with the same weights, port cfg)."""
    if name == "trained":
        jcfg, pcfg = jax_sf.SORTFORMER_TEST, port_sf.SORTFORMER_TEST
    else:
        jcfg, pcfg = jax_sf.SortformerConfig(**MID), port_sf.SortformerConfig(**MID)
    jm = jax_sf.SortformerModel(jcfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, jcfg.n_mels, jcfg.chunk_frames * 8)))
    if name == "trained":
        params = load_params(CKPT / "encoder.npz", params)
    pm = port_sf.SortformerModel(pcfg, device="cpu").eval()
    load_state(pm, from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, pm, jcfg, pcfg


@pytest.fixture(scope="module", params=["trained", "mid"])
def pair(request):
    return _pair(request.param)


def _mel(seed: int, n: int, n_mels: int, t: int) -> np.ndarray:
    return (np.random.RandomState(seed).randn(n, n_mels, t) * 2.0).astype(np.float32)


def _assert_states_close(got: port_sf.SortformerState, want: jax_sf.SortformerState) -> None:
    for name, g, w in zip(port_sf.SortformerState._fields, got, want):
        w = np.asarray(w)
        if w.dtype == bool or w.dtype.kind == "i":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, err_msg=name)


def test_encode_frames_and_offline_pass_match_jax(pair):
    jm, params, pm, jcfg, _ = pair
    mel = _mel(0, 2, jcfg.n_mels, 96)
    want = np.asarray(jm.apply(params, mel, method=jax_sf.SortformerModel.encode_frames))
    got = pm.encode_frames(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 12, jcfg.d_model)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(pm(torch.from_numpy(mel)).numpy(),
                               np.asarray(jm.apply(params, mel)), atol=ATOL)


def test_predict_with_masks_matches_jax(pair):
    """Row 0 has padded positions; row 1 is fully masked (uniform attention
    over finfo.min scores, as NeMo's, never NaN)."""
    jm, params, pm, jcfg, _ = pair
    ctx = np.random.RandomState(1).randn(2, 30, jcfg.d_model).astype(np.float32)
    mask = np.ones((2, 30), bool)
    mask[0, 7:12] = False
    mask[1] = False
    want = np.asarray(jm.apply(params, ctx, mask, method=jax_sf.SortformerModel.predict))
    got = pm.predict(torch.from_numpy(ctx), torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_streaming_step_and_scan_match_jax(pair):
    """One `streaming_step` from the empty state, then a scan over 10
    chunks (FIFO fills, overflows and compresses into the speaker cache):
    predictions and every state field after it."""
    jm, params, pm, jcfg, pcfg = pair
    T = jcfg.chunk_frames * 8
    mel = _mel(2, 10, jcfg.n_mels, T)
    jp, js = jax_sf.streaming_step(jm, params, mel[:1], jax_sf.init_state(jcfg, 1), jcfg)
    pp, ps = port_sf.streaming_step(pm, torch.from_numpy(mel[:1]),
                                    port_sf.init_state(pcfg, 1, "cpu"), pcfg)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=ATOL)
    _assert_states_close(ps, js)

    jpreds, jfinal = jax_sf.streaming_scan_program(jm, params, mel, jax_sf.init_state(jcfg, 1),
                                                   jcfg)
    ppreds, pfinal = port_sf.streaming_scan_program(pm, torch.from_numpy(mel),
                                                    port_sf.init_state(pcfg, 1, "cpu"), pcfg)
    np.testing.assert_allclose(ppreds.numpy(), np.asarray(jpreds), atol=ATOL)
    _assert_states_close(pfinal, jfinal)
    assert int(pfinal.fifo_len_valid[0]) == pcfg.fifo_len and bool(pfinal.spkcache_mask.any())
    # stopping early (the bucket's padding chunks) keeps the first predictions
    first, _ = port_sf.streaming_scan_program(pm, torch.from_numpy(mel),
                                              port_sf.init_state(pcfg, 1, "cpu"), pcfg, 6)
    np.testing.assert_array_equal(first.numpy(), ppreds[:6].numpy())


def test_cache_compression_breaks_ties_as_lax_top_k():
    """With the head zeroed every valid prediction is sigmoid(bias), so all
    valid candidates tie; the invalid slots tie at -1.0. The port's stable
    descending sort keeps the lower indices, as `jax.lax.top_k` does: the
    same speaker-cache slots, mask and predictions after each of 6 steps
    (the first steps compress only invalid candidates, the later ones only
    tied valid ones)."""
    jm, params, pm, jcfg, pcfg = _pair("trained")
    params = jax.tree_util.tree_map(lambda x: x, params)
    params["params"]["head"]["kernel"] = jnp.zeros_like(params["params"]["head"]["kernel"])
    with torch.no_grad():
        pm.head.weight.zero_()
    T = jcfg.chunk_frames * 8
    mel = _mel(3, 6, jcfg.n_mels, T)
    jstate, pstate = jax_sf.init_state(jcfg, 1), port_sf.init_state(pcfg, 1, "cpu")
    masks = []
    for i in range(6):
        _, jstate = jax_sf.streaming_step(jm, params, mel[i : i + 1], jstate, jcfg)
        _, pstate = port_sf.streaming_step(pm, torch.from_numpy(mel[i : i + 1]), pstate, pcfg)
        _assert_states_close(pstate, jstate)
        masks.append(bool(pstate.spkcache_mask.any()))
    assert masks[0] is False and masks[-1] is True
    preds = pstate.spkcache_preds[0][pstate.spkcache_mask[0]].numpy()
    assert np.all(preds == preds[0])  # every kept slot came from a tie


# ------------------------------------------------------------------ managers


def _segments(result):
    return [(s.speaker_id, s.start_time, s.end_time) for s in result.segments]


@pytest.fixture(scope="module")
def trained_pair():
    return (JaxDiarizer(jax_sf.SORTFORMER_TEST, checkpoint_dir=CKPT),
            PortDiarizer(port_sf.SORTFORMER_TEST, checkpoint_dir=CKPT, device="cpu"))


@pytest.mark.parametrize("method", ["process_offline", "process"])
def test_trained_fixture_segments_equal_jax(trained_pair, method):
    """The held-out 60 s mixture of `eval_sortformer_fixture` (and a
    second one): the same segments as the JAX manager."""
    jd, pd = trained_pair
    for seed in (4242, 99):
        mix, _, _ = jax_tc.diarizer_mixture(np.random.RandomState(seed), 60.0)
        want = getattr(jd, method)(mix)
        got = getattr(pd, method)(mix)
        assert _segments(got) == pytest.approx(_segments(want), abs=1e-9)
        assert got.speaker_count == want.speaker_count


def test_trained_fixture_der_within_gate():
    der = port_fixtures.eval_sortformer_fixture(device="cpu")
    assert der <= port_fixtures.DIAR_DER_GATE
    assert der == pytest.approx(jax_fixtures.eval_sortformer_fixture(), abs=1e-9)


def test_stream_program_matches_per_chunk_steps(trained_pair):
    """`tests/test_sortformer.py::test_stream_scan_matches_per_chunk_steps`
    on the port: the batched program equals looping `process_chunk`."""
    _, d = trained_pair
    rng = np.random.RandomState(7)
    chunk_samples = d.cfg.chunk_frames * 1280
    n = 5
    audio = (rng.randn(chunk_samples * n) * 0.1).astype(np.float32)
    state = d.make_state()
    loop_preds = []
    for i in range(n):
        preds, state = d.process_chunk(audio[i * chunk_samples : (i + 1) * chunk_samples], state)
        loop_preds.append(preds)
    loop_preds = np.concatenate(loop_preds)
    bucket = 1 << (n - 1).bit_length()
    buf = np.zeros((bucket, chunk_samples), np.float32)
    buf.reshape(-1)[: audio.size] = audio
    scan_preds, _ = d.stream_program(torch.from_numpy(buf), d.make_state())
    scan_preds = scan_preds.numpy().reshape(-1, 4)[: n * d.cfg.chunk_frames]
    np.testing.assert_allclose(scan_preds, loop_preds, atol=2e-4)
    assert d.process(audio).timings.total_seconds > 0


def test_offline_windows_match_single_and_int16(trained_pair):
    """`tests/test_sortformer.py::test_offline_batched_windows_match_single`
    on the port: windows cut by reshape/slice from the flat recording equal
    one-window passes on hand-cut windows, and int16 PCM equals f32."""
    _, d = trained_pair
    rng = np.random.RandomState(8)
    window_samples = OFFLINE_WINDOW_MEL * 160
    overlap = 64 * 1280
    step = window_samples - overlap
    flat_real = np.round(rng.randn(2 * step + overlap) * 3000).astype(np.int16)
    samples = flat_real.astype(np.float32) / 32768.0
    bucket = 4
    flat = np.zeros((bucket + 1) * step, np.float32)
    flat[: samples.size] = samples
    batched = d.offline_windows(torch.from_numpy(flat), bucket, step, window_samples).numpy()
    for i in range(2):
        win = np.zeros(window_samples, np.float32)
        seg = samples[i * step : i * step + window_samples]
        win[: seg.size] = seg
        mel, _ = d.mel(torch.from_numpy(win)[None])
        solo = d.model(mel[:, :, :OFFLINE_WINDOW_MEL]).numpy()[0]
        np.testing.assert_allclose(batched[i], solo, atol=2e-4)
    flat16 = np.zeros((bucket + 1) * step, np.int16)
    flat16[: flat_real.size] = flat_real
    batched16 = d.offline_windows(torch.from_numpy(flat16), bucket, step, window_samples).numpy()
    np.testing.assert_allclose(batched16, batched, atol=1e-5)


def test_set_mesh_raises_until_the_port_has_a_mesh(trained_pair):
    _, d = trained_pair
    d.set_mesh(None)
    with pytest.raises(NotImplementedError):
        d.set_mesh(object())


# ------------------------------------------------- the JAX suites' own cases

SORTFORMER_EDITS = (
    ("SortformerDiarizer(SORTFORMER_TEST, threshold=0.5)",
     'SortformerDiarizer(SORTFORMER_TEST, threshold=0.5, device="cpu")'),
    ("SortformerDiarizer(SORTFORMER_TEST, threshold=0.0)",
     'SortformerDiarizer(SORTFORMER_TEST, threshold=0.0, device="cpu")'),
)
# restated above against the port's programs
_JAX_PROGRAM_CASES = ("test_stream_scan_matches_per_chunk_steps",
                      "test_offline_batched_windows_match_single")
# SORTFORMER_V2 in JAX; the session mechanics run at SORTFORMER_TEST here
ENROLLMENT_EDITS = (
    ("from fluidaudio_tpu.diarizer.sortformer import SortformerDiarizer",
     "from fluidaudio_tpu.diarizer.sortformer import SortformerDiarizer\n"
     "from fluidaudio_tpu.models.sortformer import SORTFORMER_TEST"),
    ("SortformerDiarizer(threshold=0.5)",
     'SortformerDiarizer(SORTFORMER_TEST, threshold=0.5, device="cpu")'),
)
_ENROLL_MODULES = ("diarizer.sortformer", "models.sortformer")

globals().update(jax_test_fixtures("test_sortformer.py", edits=SORTFORMER_EDITS))
globals().update({name: fx for name, fx in jax_test_fixtures(
    "test_speaker_enrollment.py", _ENROLL_MODULES, edits=ENROLLMENT_EDITS).items()
    if name == "sortformer"})
SORTFORMER_CASES = [c for c in jax_cases("test_sortformer.py", edits=SORTFORMER_EDITS,
                                         fixtures=True)
                    if c.id not in _JAX_PROGRAM_CASES]
ENROLLMENT_CASES = jax_cases("test_speaker_enrollment.py", _ENROLL_MODULES,
                             ("TestSortformerEnrollment",), edits=ENROLLMENT_EDITS,
                             fixtures=True)


@pytest.mark.parametrize("case", SORTFORMER_CASES)
def test_jax_sortformer_case_on_the_port(case, request):
    case(request)


@pytest.mark.parametrize("case", ENROLLMENT_CASES)
def test_jax_enrollment_case_on_the_port(case, request):
    case(request)


def test_cases_cover_the_jax_suites():
    ids = {c.id for c in SORTFORMER_CASES} | set(_JAX_PROGRAM_CASES)
    assert len(ids) == len(jax_cases("test_sortformer.py", edits=SORTFORMER_EDITS,
                                     fixtures=True)) == 17
    assert len(ENROLLMENT_CASES) == 7
