"""Serving builds no autograd graph, now that the encoder, predictor and
joint forwards are differentiable (the train step needs them so).

Each entry point runs on its trained tiny fixture on the CPU inside
`torch.autograd.graph.saved_tensors_hooks`, whose pack hook sees every
tensor autograd saves for a backward: serving must save none. Where an
entry point hands back tensors (the batch pipeline, `jit_sharded_infer`),
they carry no history (`grad_fn is None`, `requires_grad` false).
Covered: the Parakeet TDT batch pipeline and long-form `transcribe`,
streaming EOU (single and multi-stream), VAD, Sortformer (offline and
stateful), Kokoro TTS, the CTC keyword spotter and the sharded infer on
a 1 x 1 mesh.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from fluidaudio_tpu_torch.train import fixtures as fx
from fluidaudio_tpu_torch.train import tiny_corpus as tc
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401
from tests.test_torch_parallel import cpu_mesh_1x1  # noqa: F401


@contextlib.contextmanager
def saved_for_backward():
    """-> a list that collects the shape of every tensor autograd saves."""
    saved: list = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        yield saved


def _no_history(*tensors) -> bool:
    return all(t.grad_fn is None and not t.requires_grad for t in tensors)


@pytest.fixture(scope="module")
def asr_models():
    from fluidaudio_tpu_torch.models.zoo import AsrModels

    return AsrModels.load("test-tiny", checkpoint_dir=fx.trained_assets_dir() / "asr",
                          allow_random_init=False, device="cpu")


def test_batch_pipeline_and_transcribe(asr_models):
    from fluidaudio_tpu_torch.asr.manager import AsrManager

    mgr = AsrManager(asr_models)
    ids = np.random.RandomState(3).randint(0, tc.N_WORDS, size=40)
    audio = tc.make_utterance(ids, np.random.RandomState(4))  # > 15 s: long-form windows
    with saved_for_backward() as saved:
        text = mgr.transcribe(audio).text
        result, enc_len = mgr.build_pipeline(2)(torch.zeros(2, 16_000),
                                                torch.full((2,), 16_000, dtype=torch.int32))
    assert saved == [] and text == tc.transcript_text(ids)
    assert _no_history(result.tokens, result.counts, result.confidences, enc_len)


def test_streaming_eou_single_and_multi_stream():
    from fluidaudio_tpu_torch.asr.streaming_eou import EOU_TEST, StreamingEouAsrManager

    mgr = StreamingEouAsrManager(320, spec=EOU_TEST, checkpoint_dir=fx.trained_assets_dir() / "eou",
                                 device="cpu")
    (ids, audio), = fx.eou_fixture_utterances(n_utts=1)
    with saved_for_backward() as saved:
        state = mgr.make_state()
        mgr.process(audio, state)
        final = mgr.finish(state)
        session = mgr.make_multi_state(2)
        mgr.process_multi(session, [audio, audio[:20_000]])
        finals = mgr.flush_multi(session)
    assert saved == []
    assert final.text == finals[0].text == tc.transcript_text(ids)


def test_vad_batch():
    from fluidaudio_tpu_torch.vad import VadManager

    mgr = VadManager(checkpoint_dir=fx.trained_assets_dir() / "vad", device="cpu")
    clips = [clip for _, clip in fx.vad_fixture_clips(clips=3)]
    with saved_for_backward() as saved:
        results = mgr.process_batch(clips)
    assert saved == [] and len(results) == 3


def test_sortformer_offline_and_stateful():
    from fluidaudio_tpu_torch.diarizer.sortformer import SortformerDiarizer
    from fluidaudio_tpu_torch.models.sortformer import SORTFORMER_TEST

    diar = SortformerDiarizer(SORTFORMER_TEST,
                              checkpoint_dir=fx.trained_assets_dir() / "sortformer",
                              device="cpu")
    mix, _, _ = tc.diarizer_mixture(np.random.RandomState(4242), 40.0)
    with saved_for_backward() as saved:
        offline = diar.process_offline(mix)
        stateful = diar.process(mix)
    assert saved == [] and offline.speaker_count == stateful.speaker_count == 2


def test_kokoro_tts():
    mgr = fx.load_tts_manager(device="cpu")
    with saved_for_backward() as saved:
        result = mgr.synthesize("w3 w7")
    assert saved == [] and np.asarray(result.samples).size > 0


def test_sharded_infer_on_a_1x1_mesh(asr_models, cpu_mesh_1x1):
    from fluidaudio_tpu_torch.parallel.infer import jit_sharded_infer

    m = asr_models
    params = {f"{name}.{k}": v for name, part in (("encoder", m.encoder),
                                                  ("predictor", m.predictor),
                                                  ("joint", m.joint))
              for k, v in part.named_parameters()}
    infer = jit_sharded_infer(cpu_mesh_1x1, (m.encoder, m.predictor, m.joint),
                              m.spec.predictor, params)
    audio = torch.from_numpy(tc.make_utterance([3, 7, 1], np.random.RandomState(5)))[None]
    mel, mel_len = m.mel(audio, torch.tensor([audio.shape[1]], dtype=torch.int32))
    with saved_for_backward() as saved:
        tokens, counts, enc_len = infer(params, mel, mel_len)
    assert saved == [] and _no_history(tokens, counts, enc_len)
    assert tokens[0, : int(counts[0])].tolist() == [3, 7, 1]


def test_keyword_spotter():
    """An encoder whose parameters require grad (the spotter builds its own):
    serving relies on `no_grad` alone."""
    spotter, _ = fx._ctc_spotter(device="cpu")
    assert any(p.requires_grad for p in spotter.encoder.parameters())
    audio = tc.make_utterance([2, 9, 4], np.random.RandomState(6))
    with saved_for_backward() as saved:
        canvas = spotter.log_probs(audio)
    assert saved == [] and np.isfinite(np.asarray(canvas)).all()
