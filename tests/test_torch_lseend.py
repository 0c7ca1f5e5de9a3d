"""LS-EEND of the PyTorch port against the JAX package.

- `subsample_with_context`: exact, edge clamp included.
- `LsEendModel` on `LSEEND_TEST` over six steps carrying the state (the
  first step's `slot_init`, the warm-up mask on absolute frames), with the
  JAX package's seeded init loaded through `utils/weights.py` (the
  DenseGeneral `att{i}` / `slot_att` kernels by name): f32, REL_L2.
- The trained `lseend` fixture (the oracle): `eval_lseend_fixture` DER and
  `process` segments equal JAX's, and the streaming session (ragged 1 s
  pushes, `finish_stream`) gives JAX's segments.
- The JAX suites' own cases on the port (`jax_cases`): `tests/
  test_lseend.py` but its converter test (it needs the JAX `convert/`), the
  LS-EEND half of `test_speaker_enrollment.py` and `TestTrainedLsEend` of
  `test_trained_fixtures.py`, with `device="cpu"` added where they build a
  diarizer.

REL_L2 = 1e-5 (f32 reductions in another order). Segments compare at 1e-9 s.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidaudio_tpu.diarizer.lseend import LSEENDDiarizer as JaxDiarizer
from fluidaudio_tpu.models import lseend as jax_lseend
from fluidaudio_tpu.train import fixtures as jax_fx
from fluidaudio_tpu.train import tiny_corpus as jax_tc
from fluidaudio_tpu_torch.diarizer.lseend import LSEENDDiarizer as PortDiarizer
from fluidaudio_tpu_torch.models import lseend as port_lseend
from fluidaudio_tpu_torch.train import fixtures as port_fx
from fluidaudio_tpu_torch.utils.weights import from_jax_params, load_state
from tests.test_torch_custom_vocab import jax_cases, jax_fixtures, one_torch_thread  # noqa: F401

REL_L2 = 1e-5
LSEEND_DIR = jax_fx.trained_assets_dir() / "lseend"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _segments(result):
    return [(s.speaker_id, s.start_time, s.end_time) for s in result.segments]


@pytest.mark.parametrize("T", [40, 47, 7])
def test_subsample_with_context_is_exact(T):
    cfg = port_lseend.LSEEND_TEST
    mel = np.random.RandomState(T).randn(2, cfg.n_mels, T).astype(np.float32)
    want = np.asarray(jax_lseend.subsample_with_context(jnp.asarray(mel), cfg))
    got = port_lseend.subsample_with_context(torch.as_tensor(mel), cfg).numpy()
    assert got.shape == want.shape == (2, T // cfg.subsample, cfg.feat_dim)
    np.testing.assert_array_equal(got, want)


def test_model_steps_with_state_equal_jax():
    """Six 3-frame steps from the zero state: the first takes `slot_init`,
    frames 0-8 are inside the warm-up (exact zeros in both), the state
    carries the attractors and the frame count."""
    cfg_j, cfg_p = jax_lseend.LSEEND_TEST, port_lseend.LSEEND_TEST
    rs = np.random.RandomState(0)
    feats = (rs.randn(6, 1, 3, cfg_j.feat_dim) * 0.5).astype(np.float32)
    model_j = jax_lseend.LsEendModel(cfg_j)
    params = jax.jit(model_j.init)(jax.random.PRNGKey(3), jnp.asarray(feats[0]),
                                   jax_lseend.init_state(cfg_j, 1))
    step = jax.jit(model_j.apply)
    model_p = port_lseend.LsEendModel(cfg_p, device="cpu")
    load_state(model_p, from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    state_j, state_p = jax_lseend.init_state(cfg_j, 1), port_lseend.init_state(cfg_p, 1, "cpu")
    for i in range(6):
        want, state_j = step(params, jnp.asarray(feats[i]), state_j)
        got, state_p = model_p(torch.as_tensor(feats[i]), state_p)
        assert _rel(got.numpy(), want) <= REL_L2, i
        assert _rel(state_p.attractors.numpy(), state_j.attractors) <= REL_L2, i
        assert int(state_p.frames_seen[0]) == int(state_j.frames_seen[0]) == 3 * (i + 1)
        if i < 3:  # frames 0..8
            assert not got.numpy().any() and not np.asarray(want).any()


def test_step_program_equals_the_eager_steps():
    """`StepProgram.scan` over N blocks (eager here; a CUDA graph on the
    card) equals N calls of the model."""
    cfg = port_lseend.LSEEND_TEST
    model = port_lseend.LsEendModel(cfg, device="cpu")
    torch.manual_seed(0)
    for p in model.parameters():
        p.data.normal_(0.0, 0.2)
    feats = torch.randn(5, 2, cfg.feat_dim)
    got, state = port_lseend.StepProgram(model).scan(feats, port_lseend.init_state(cfg, 1))
    want, s = [], port_lseend.init_state(cfg, 1)
    for i in range(5):
        a, s = model(feats[i : i + 1], s)
        want.append(a[0])
    torch.testing.assert_close(got, torch.stack(want), rtol=0, atol=0)
    torch.testing.assert_close(state.attractors, s.attractors, rtol=0, atol=0)


def test_trained_fixture_process_and_der_equal_jax():
    rs = np.random.RandomState(8642)
    mix, _, _ = jax_tc.diarizer_mixture(rs, 60.0, overlap_prob=0.0)
    want = JaxDiarizer(jax_lseend.LSEEND_TEST, step_ms=500, checkpoint_dir=LSEEND_DIR).process(mix)
    got = PortDiarizer(port_lseend.LSEEND_TEST, step_ms=500, checkpoint_dir=LSEEND_DIR,
                       device="cpu").process(mix)
    assert _segments(got) == pytest.approx(_segments(want), abs=1e-9)
    assert got.speaker_count == want.speaker_count == 2
    der = port_fx.eval_lseend_fixture(device="cpu")
    assert der == jax_fx.eval_lseend_fixture()
    assert der <= port_fx.LSEEND_DER_GATE


@pytest.mark.parametrize("step_ms", [500, 300])
def test_trained_fixture_streaming_session_equals_jax(step_ms):
    """Ragged 1 s pushes through the chunk queue, then `finish_stream`
    drains the partial tail: the same segments as JAX, push by push."""
    rs = np.random.RandomState(123)
    mix, _, _ = jax_tc.diarizer_mixture(rs, 30.0, overlap_prob=0.0)
    mix = mix[: mix.size - 3_000]  # leaves a partial step for finish_stream
    diars = (JaxDiarizer(jax_lseend.LSEEND_TEST, step_ms=step_ms, checkpoint_dir=LSEEND_DIR),
             PortDiarizer(port_lseend.LSEEND_TEST, step_ms=step_ms, checkpoint_dir=LSEEND_DIR,
                          device="cpu"))
    out = []
    for d in diars:
        d.reset_session()
        segs = [_segments(d.process_stream(mix[off : off + 16_000]))
                for off in range(0, mix.size, 16_000)]
        segs.append(_segments(d.finish_stream()))
        out.append((segs, d._session_frames))
    (want, want_frames), (got, got_frames) = out
    assert got_frames == want_frames
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == pytest.approx(w, abs=1e-9)
    assert sum(len(s) for s in got) > 0


def test_enrollment_names_the_slot_jax_names():
    """`enroll_speaker` on the trained fixture: the same named track, and the
    stream that follows gives JAX's segments under that name."""
    rs = np.random.RandomState(31)
    speaker = jax_tc.speaker_wave(1, 4.0, rs)
    mix, _, _ = jax_tc.diarizer_mixture(np.random.RandomState(32), 10.0, overlap_prob=0.0)
    out = []
    for d in (JaxDiarizer(jax_lseend.LSEEND_TEST, step_ms=500, checkpoint_dir=LSEEND_DIR),
              PortDiarizer(port_lseend.LSEEND_TEST, step_ms=500, checkpoint_dir=LSEEND_DIR,
                           device="cpu")):
        name = d.enroll_speaker(speaker, name="Bob")
        out.append((name, d.speaker_names, _segments(d.process_stream(mix))))
    assert out[1][:2] == out[0][:2]
    assert out[1][2] == pytest.approx(out[0][2], abs=1e-9)


def test_lseend_batch_is_jax_s():
    """The LS-EEND training batches of `tiny_corpus` (8 kHz mixtures with
    arrival-order frame labels) equal the JAX package's."""
    from fluidaudio_tpu_torch.train import tiny_corpus as port_tc

    want = jax_tc.lseend_batch(np.random.RandomState(4), 2, 3)
    got = port_tc.lseend_batch(np.random.RandomState(4), 2, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PortDiarizer(port_lseend.LSEEND_TEST)


def test_checkpoint_dir_none_reads_the_model_cache(tmp_path, monkeypatch):
    """`checkpoint_dir=None` loads `$FLUID_CACHE_DIR/Models/ls-eend/model.npz`,
    as JAX does (no seeded random init when the cache holds weights)."""
    import shutil

    from fluidaudio_tpu_torch.registry import DownloadUtils, Repo

    monkeypatch.setenv("FLUID_CACHE_DIR", str(tmp_path))
    folder = DownloadUtils.repo_dir(Repo.LS_EEND)
    folder.mkdir(parents=True)
    shutil.copy(LSEEND_DIR / "model.npz", folder / "model.npz")
    rs = np.random.RandomState(8)
    mix, _, _ = jax_tc.diarizer_mixture(rs, 12.0, overlap_prob=0.0)
    cached = PortDiarizer(port_lseend.LSEEND_TEST, device="cpu").process(mix)
    direct = PortDiarizer(port_lseend.LSEEND_TEST, checkpoint_dir=LSEEND_DIR,
                          device="cpu").process(mix)
    assert _segments(cached) == _segments(direct) and cached.segments


# ------------------------------------------------- the JAX suites' own cases

LSEEND_EDITS = (
    ("LSEENDDiarizer(LSEEND_TEST, step_ms=200)",
     'LSEENDDiarizer(LSEEND_TEST, step_ms=200, device="cpu")'),
    ("import jax.numpy as jnp\n\n\ndef test_subsample",
     "import jax.numpy as jnp\nimport torch\n\n\ndef test_subsample"),
    ("mel = jnp.asarray(np.arange(", "mel = torch.as_tensor(np.arange("),
)
ENROLLMENT_EDITS = (("LSEENDDiarizer(step_ms=500)", 'LSEENDDiarizer(step_ms=500, device="cpu")'),)
TRAINED_EDITS = (
    ("from fluidaudio_tpu.train import fixtures as fx\n",
     "from fluidaudio_tpu.train import fixtures as fx\n"
     "from fluidaudio_tpu_torch.train import fixtures as port_fx\n"),
    ("fx.eval_lseend_fixture()", 'port_fx.eval_lseend_fixture(device="cpu")'),
    ('checkpoint_dir=fx.trained_assets_dir() / "lseend")',
     'checkpoint_dir=fx.trained_assets_dir() / "lseend", device="cpu")'),
)
_LSEEND_MODULES = ("diarizer.lseend", "models.lseend", "utils.chunk_queue",
                   "diarizer.metrics", "diarizer.types")

globals().update(jax_fixtures("test_lseend.py", edits=LSEEND_EDITS))
globals().update({name: fx for name, fx in jax_fixtures(
    "test_speaker_enrollment.py", ("diarizer.lseend",), edits=ENROLLMENT_EDITS).items()
    if name == "lseend"})
_CONVERTER_CASE = "test_lseend_converter_tree_matches_and_mha_equivalence"
LSEEND_CASES = [c for c in jax_cases("test_lseend.py", edits=LSEEND_EDITS, fixtures=True)
                if c.id != _CONVERTER_CASE]
ENROLLMENT_CASES = jax_cases("test_speaker_enrollment.py", ("diarizer.lseend",),
                             ("TestLseendEnrollment",), edits=ENROLLMENT_EDITS, fixtures=True)
TRAINED_CASES = jax_cases("test_trained_fixtures.py", _LSEEND_MODULES, ("TestTrainedLsEend",),
                          edits=TRAINED_EDITS)


@pytest.mark.parametrize("case", LSEEND_CASES + ENROLLMENT_CASES + TRAINED_CASES)
def test_jax_lseend_case_on_the_port(case, request):
    case(request)


def test_cases_cover_the_jax_suites():
    assert len(LSEEND_CASES) == 12  # 13, less the converter test
    assert len(ENROLLMENT_CASES) == 4
    assert {c.id for c in TRAINED_CASES} == {
        "TestTrainedLsEend.test_offline_der_below_gate",
        "TestTrainedLsEend.test_streaming_session_matches_offline"}
