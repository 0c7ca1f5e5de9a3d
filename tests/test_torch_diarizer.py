"""The pyannote/WeSpeaker diarizers of the PyTorch port against JAX.

- Whole paths on the trained `offline` fixture (the oracle; no download):
  `OfflineDiarizerManager.process` and the online `DiarizerManager.process`
  give the JAX managers' segments on the fixtures' held-out mixtures, with
  DER within `DIAR_DER_GATE` (offline) and `ONLINE_DIAR_DER_GATE` (online,
  speaker count equal).
- Speaker enrollment and `SpeakerVerifier` over the online manager's
  embeddings: the same embeddings (within REL_L2), matches and rejections
  as JAX's.
- Every case of `tests/test_speaker_manager.py`, `test_timeline.py`,
  `test_speaker_id.py`, `test_diarizer.py`, `test_diarizer_protocol.py` and
  `test_offline_diarizer.py` runs on the port (`jax_cases`, with
  `device="cpu"` added to the managers they build). They build the managers
  at full width (the pyannote attention net and ResNet34 with seeded
  weights), as JAX does, except the offline progress cases, which test the
  progress callback's contract only and run on the trained `offline`
  fixture (its reduced configs and checkpoints).

REL_L2 = 1e-5 on embeddings (f32 reductions in another order).
"""

from __future__ import annotations

import numpy as np
import pytest

from fluidaudio_tpu.diarizer.speaker_id import SpeakerVerifier as JaxVerifier
from fluidaudio_tpu.train import fixtures as jax_fixtures
from fluidaudio_tpu.train import tiny_corpus as jax_tc
from fluidaudio_tpu_torch.diarizer.speaker_id import SpeakerVerifier as PortVerifier
from fluidaudio_tpu_torch.train import fixtures as port_fixtures
from tests.test_torch_custom_vocab import jax_cases, jax_fixtures as jax_test_fixtures
from tests.test_torch_custom_vocab import jax_native_on_the_port_build, one_torch_thread  # noqa: F401

REL_L2 = 1e-5


def _segments(result):
    return [(s.speaker_id, s.start_time, s.end_time) for s in result.segments]


def _mixture(seed: int, seconds: float = 60.0):
    return jax_tc.diarizer_mixture(np.random.RandomState(seed), seconds, overlap_prob=0.0)


@pytest.fixture(scope="module")
def online_pair():
    return (jax_fixtures.online_diarizer_manager(),
            port_fixtures.online_diarizer_manager(device="cpu"))


def test_offline_fixture_segments_equal_jax_and_der_within_gate():
    """The held-out 60 s mixture of `eval_offline_diarizer_fixture`:
    segmentation -> embeddings -> PLDA -> AHC (cut at 0.30) -> VBx ->
    reconstruction gives JAX's segments, and DER within the gate."""
    mix, ref, _ = _mixture(13579)
    want = jax_fixtures.offline_diarizer_manager().process(mix)
    got = port_fixtures.offline_diarizer_manager(device="cpu").process(mix)
    assert _segments(got) == pytest.approx(_segments(want), abs=1e-9)
    assert got.speaker_count == want.speaker_count == 2
    assert got.timings.segmentation_seconds > 0 and got.timings.embedding_seconds > 0
    der = port_fixtures.eval_offline_diarizer_fixture(device="cpu")
    assert der <= port_fixtures.DIAR_DER_GATE


def test_offline_fixture_with_exact_speaker_count_equals_jax():
    mix, _, _ = _mixture(24680, 40.0)
    want = jax_fixtures.offline_diarizer_manager(
        jax_fixtures.offline_diarizer_config().with_speakers(exactly=3)).process(mix)
    got = port_fixtures.offline_diarizer_manager(
        port_fixtures.offline_diarizer_config().with_speakers(exactly=3), device="cpu").process(mix)
    assert _segments(got) == pytest.approx(_segments(want), abs=1e-9)


def test_online_fixture_segments_equal_jax_and_der_within_gate(online_pair):
    """`eval_online_diarizer_fixture`'s mixture through 10 s chunks and the
    online SpeakerManager: JAX's segments and speaker count, DER in gate."""
    jm, _ = online_pair
    mix, _, _ = _mixture(97531)
    want = jm.process(mix)
    got = port_fixtures.online_diarizer_manager(device="cpu").process(mix)
    assert _segments(got) == pytest.approx(_segments(want), abs=1e-9)
    assert got.speaker_count == want.speaker_count
    result = port_fixtures.eval_online_diarizer_fixture(device="cpu")
    assert result["der"] <= port_fixtures.ONLINE_DIAR_DER_GATE
    assert result["speaker_count"] == 2


def test_enrollment_and_speaker_id_on_the_online_manager(online_pair):
    """Enroll each fixture speaker from 3 s of their voice, then verify and
    identify fresh audio through `SpeakerVerifier` over the online
    manager's embeddings: the same embeddings and decisions as JAX."""
    jm, pm = online_pair
    rs = np.random.RandomState(11)
    enroll = [jax_tc.speaker_wave(k, 3.0, rs) for k in (0, 1)]
    probe = [jax_tc.speaker_wave(k, 2.0, rs) for k in (0, 1)]
    for audio in enroll + probe:
        want = jm.extract_speaker_embedding(audio)
        got = pm.extract_speaker_embedding(audio)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < REL_L2

    pm.enroll_speaker(enroll[0], "alice", name="Alice")
    jm.enroll_speaker(enroll[0], "alice", name="Alice")
    spk = pm.speaker_manager.get_speaker("alice")
    assert spk.name == "Alice" and spk.current_embedding.shape == (32,)

    verifiers = []
    for verifier_cls, mgr in ((JaxVerifier, jm), (PortVerifier, pm)):
        v = verifier_cls(embedder=mgr.extract_speaker_embedding, threshold=0.5)
        v.enroll("alice", enroll[0])
        v.enroll("bob", enroll[1])
        verifiers.append(v)
    jv, pv = verifiers
    for k, audio in enumerate(probe):
        name = ("alice", "bob")[k]
        got, want = pv.identify(audio), jv.identify(audio)
        assert got.speaker_id == want.speaker_id == name
        assert got.similarity == pytest.approx(want.similarity, abs=1e-5)
        assert pv.verify(name, audio).is_match and not pv.verify(("bob", "alice")[k], audio).is_match


# ------------------------------------------------- the JAX suites' own cases

ONLINE_EDITS = (
    ("DiarizerManager(DiarizerConfig(min_active_frames_count=0.0, min_speech_duration=0.1))",
     'DiarizerManager(DiarizerConfig(min_active_frames_count=0.0, min_speech_duration=0.1), '
     'device="cpu")'),
)
PROTOCOL_EDITS = (
    ("""DiarizerManager(DiarizerConfig(min_active_frames_count=0.0,
                                          min_speech_duration=0.1))""",
     """DiarizerManager(DiarizerConfig(min_active_frames_count=0.0,
                                          min_speech_duration=0.1), device="cpu")"""),
)
# the smoke case at full width; the progress cases on the trained fixture
# (they hold the callback's contract, not the numerics)
OFFLINE_EDITS = (
    ("""    mgr = OfflineDiarizerManager()
    rng = np.random.RandomState(0)""", """    mgr = OfflineDiarizerManager(device="cpu")
    rng = np.random.RandomState(0)"""),
    ("""    return OfflineDiarizerManager()
""", """    from fluidaudio_tpu.train.fixtures import offline_diarizer_manager

    return offline_diarizer_manager(device="cpu")
"""),
)

SUITES = {
    "test_speaker_manager.py": (),
    "test_timeline.py": (),
    "test_speaker_id.py": (),
    "test_diarizer.py": ONLINE_EDITS,
    "test_diarizer_protocol.py": PROTOCOL_EDITS,
    "test_offline_diarizer.py": OFFLINE_EDITS,
}
for _file, _edits in SUITES.items():
    globals().update(jax_test_fixtures(_file, edits=_edits))
CASES = [pytest.param(case.values[0], id=f"{file[:-3]}::{case.id}")
         for file, edits in SUITES.items()
         for case in jax_cases(file, edits=edits, fixtures=True)]


@pytest.mark.parametrize("case", CASES)
def test_jax_diarizer_case_on_the_port(case, request):
    case(request)


def test_cases_cover_the_jax_suites():
    assert len(CASES) == 44 + 20 + 5 + 11 + 2 + 43
