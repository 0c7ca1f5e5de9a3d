"""The trained-fixture evaluations the CLI's guardrail calls, on the PyTorch
port against the JAX package's `train/fixtures.py`.

`eval_asr_fixture`, `eval_eou_fixture` and `eval_nemotron_fixture` run
through the port's managers on the CPU and return JAX's dicts exactly; the
held-out draws they share with the port's tests (`*_fixture_utterances`) are
JAX's draws bit for bit; `tts_source_phase` and `tts_target_audio_aligned`
give JAX's arrays bit for bit; the fixture table, `fixtures_available` and
the conventions' constants equal JAX's.
"""

import numpy as np
import pytest

from fluidaudio_tpu.train import fixtures as jax_fx
from fluidaudio_tpu.train import tiny_corpus as jax_tc
from fluidaudio_tpu_torch.train import fixtures as port_fx
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

CONSTANTS = ["ASR_WER_GATE", "VAD_F1_GATE", "DIAR_DER_GATE", "LSEEND_DER_GATE",
             "ONLINE_DIAR_DER_GATE", "ONLINE_DIAR_CLUSTER_THRESHOLD", "OFFLINE_AHC_THRESHOLD",
             "SENSEVOICE_WORD_OFFSET", "PARAFORMER_WORD_OFFSET", "COHERE_WORD_OFFSET",
             "NEMOTRON_B_OFFSET", "NEMOTRON_TAG_A", "NEMOTRON_TAG_B", "CTC_BLANK_ID",
             "KWS_RECALL_GATE", "KWS_PRECISION_GATE", "TTS_ROUNDTRIP_WER_GATE",
             "POCKET_ROUNDTRIP_WER_GATE", "STYLETTS2_ROUNDTRIP_WER_GATE", "_CORE_FAMILIES",
             "_FIXTURE_FILES"]


@pytest.mark.parametrize("name", CONSTANTS)
def test_constant_equals_jax(name):
    assert getattr(port_fx, name) == getattr(jax_fx, name)


@pytest.mark.parametrize("family", [None, *jax_fx._FIXTURE_FILES])
def test_fixtures_available_equals_jax(family, monkeypatch, tmp_path):
    families = () if family is None else (family,)
    assert port_fx.fixtures_available(*families) is jax_fx.fixtures_available(*families) is True
    monkeypatch.setattr(port_fx, "trained_assets_dir", lambda: tmp_path)
    assert port_fx.fixtures_available(*families) is False


def test_nemotron_tiny_enc_cfg_fields_equal_jax():
    import dataclasses

    assert (dataclasses.asdict(port_fx.nemotron_tiny_enc_cfg())
            == dataclasses.asdict(jax_fx.nemotron_tiny_enc_cfg()))


def _jax_asr_draws(n_words, seed):
    rs = np.random.RandomState(seed)
    out = []
    for n in n_words:
        ids = rs.randint(0, jax_tc.N_WORDS, size=n)
        out.append((ids, jax_tc.make_utterance(ids, rs)))
    return out


def test_draws_are_jax_draws():
    """The shared held-out draws, as the JAX evaluations draw them inline."""
    for (ids, audio), (want_ids, want) in zip(port_fx.asr_fixture_utterances(),
                                             _jax_asr_draws((5, 40), 12345)):
        np.testing.assert_array_equal(ids, want_ids)
        assert audio.tobytes() == want.tobytes()
    rs = np.random.RandomState(2468)
    tail = np.zeros(int(1.28 * 16_000), np.float32)
    for ids, audio in port_fx.eou_fixture_utterances():
        want_ids = rs.randint(0, jax_tc.N_WORDS, size=int(rs.randint(2, 8)))
        np.testing.assert_array_equal(ids, want_ids)
        assert audio.tobytes() == np.concatenate(
            [jax_tc.make_utterance(want_ids, rs), tail]).tobytes()
    rs = np.random.RandomState(9753)
    for u, (lang, ref, audio) in enumerate(port_fx.nemotron_fixture_utterances()):
        corpus = "a" if u % 2 == 0 else "b"
        ids = rs.randint(0, jax_tc.N_WORDS, size=int(rs.randint(2, 8)))
        assert audio.tobytes() == jax_tc.make_utterance(ids, rs, lang=corpus).tobytes()
        assert lang == ("aa-AA" if corpus == "a" else "bb-BB")
        assert ref == " ".join(jax_tc.word_text(i) if corpus == "a" else jax_tc.word_text_b(i)
                               for i in ids)


def test_eval_asr_fixture_equals_jax():
    got = port_fx.eval_asr_fixture(device="cpu")
    assert got == jax_fx.eval_asr_fixture()
    assert set(got) == {"wer_5w", "wer_40w", "wer_avg"} and got["wer_avg"] <= port_fx.ASR_WER_GATE


def test_eval_eou_fixture_equals_jax():
    got = port_fx.eval_eou_fixture(n_utts=3, device="cpu")
    assert got == jax_fx.eval_eou_fixture(n_utts=3)
    assert got == {"wer_avg": 0.0, "eou_detect_rate": 1.0}


def test_eval_nemotron_fixture_equals_jax():
    got = port_fx.eval_nemotron_fixture(n_utts=4, device="cpu")
    assert got == jax_fx.eval_nemotron_fixture(n_utts=4)
    assert got == {"wer_avg": 0.0, "lang_detect_rate": 1.0}


def test_eval_functions_default_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (port_fx.eval_asr_fixture, port_fx.eval_eou_fixture,
               port_fx.eval_nemotron_fixture):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            fn()


@pytest.mark.parametrize("variant", ["kokoro", "styletts2"])
@pytest.mark.parametrize("ids", [[3, 7, 12], [15, 0], [5, 9, 2, 14, 1, 8]])
def test_tts_target_audio_aligned_bit_equal_to_jax(variant, ids):
    frames = 1 + len(ids) * 17 + 4
    audio, f0 = port_fx.tts_target_audio_aligned(np.asarray(ids), frames, variant)
    want_audio, want_f0 = jax_fx.tts_target_audio_aligned(np.asarray(ids), frames, variant)
    assert audio.dtype == want_audio.dtype and audio.tobytes() == want_audio.tobytes()
    assert f0.tobytes() == want_f0.tobytes()
    assert np.abs(audio).max() > 0.3


@pytest.mark.parametrize("variant", ["kokoro", "styletts2"])
def test_tts_source_phase_bit_equal_to_jax(variant):
    rs = np.random.RandomState(5)
    f0 = np.where(rs.rand(96) > 0.3, rs.uniform(80, 400, 96), 0.0).astype(np.float32)
    got, want = port_fx.tts_source_phase(f0, variant), jax_fx.tts_source_phase(f0, variant)
    assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()
    # the track truncated mid-word: still bit-equal
    cut = port_fx.tts_target_audio_aligned(np.array([1, 2, 3]), 30, variant)
    want_cut = jax_fx.tts_target_audio_aligned(np.array([1, 2, 3]), 30, variant)
    assert cut[0].tobytes() == want_cut[0].tobytes()
