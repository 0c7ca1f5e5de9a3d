"""The registry of the PyTorch port, and checkpoint resolution through it.

`registry/{registry,download,doctor,datasets}.py` are copies of the JAX
package's (they import no JAX): every case of `tests/test_registry.py` and
the dataset-staging cases of `tests/test_datasets.py` run against the
port's modules (`jax_cases`, with their fixtures: `test_registry.py`'s
autouse `clean_registry` points the port's cache at a temporary directory
for every test here). Nothing is fetched: every resolution test runs with
`FLUID_OFFLINE=1`.

Checkpoint resolution: with `checkpoint_dir=None` the entry points read the
model cache (`$FLUID_CACHE_DIR/Models/<folder>`), as JAX does, and with
`allow_random_init=False` they go through `ensure_repo`. A cache holding
copies of the trained `asr`, `ctc`, `eou` and `nemotron` fixtures under
their registry folders gives the JAX and the port's managers the same text
(the port used to take seeded random weights there); with an empty cache,
`allow_random_init=False` raises `OfflineError` in both packages. The port's
`ModelRegistry` class state is its own, so both packages are set.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest

from fluidaudio_tpu.asr import streaming_eou as jax_eou
from fluidaudio_tpu.asr import streaming_nemotron as jax_nem
from fluidaudio_tpu.asr.config import ASRConfig as JaxASRConfig
from fluidaudio_tpu.asr.keyword_spotter import CtcKeywordSpotter as JaxSpotter
from fluidaudio_tpu.asr.keyword_spotter import KeywordSpotterConfig as JaxKwsConfig
from fluidaudio_tpu.asr.custom_vocab.context import CustomVocabularyContext as JaxContext
from fluidaudio_tpu.asr.custom_vocab.context import VocabularyTerm as JaxTerm
from fluidaudio_tpu.asr.manager import AsrManager as JaxAsrManager
from fluidaudio_tpu.asr.tokenizer import Tokenizer as JaxTokenizer
from fluidaudio_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from fluidaudio_tpu.models.zoo import AsrModels as JaxAsrModels
from fluidaudio_tpu.registry import ModelRegistry as JaxRegistry
from fluidaudio_tpu.registry import OfflineError as JaxOfflineError
from fluidaudio_tpu.train import fixtures as jax_fx
from fluidaudio_tpu_torch import registry as port_registry
from fluidaudio_tpu_torch.asr import streaming_eou as port_eou
from fluidaudio_tpu_torch.asr import streaming_nemotron as port_nem
from fluidaudio_tpu_torch.asr.config import ASRConfig
from fluidaudio_tpu_torch.asr.manager import AsrManager
from fluidaudio_tpu_torch.asr.multi_stream import MultiStreamEouManager
from fluidaudio_tpu_torch.models.zoo import AsrModels
from fluidaudio_tpu_torch.native import flac
from fluidaudio_tpu_torch.registry import ModelRegistry, OfflineError, Repo
from fluidaudio_tpu_torch.train import fixtures as port_fx
from fluidaudio_tpu_torch.train import tiny_corpus as tc
from tests.test_torch_custom_vocab import jax_cases, jax_fixtures, one_torch_thread  # noqa: F401

FIXTURES = jax_fx.trained_assets_dir()

globals().update(jax_fixtures("test_registry.py"))  # autouse clean_registry
REGISTRY_CASES = jax_cases("test_registry.py", fixtures=True)
DATASET_CASES = jax_cases("test_datasets.py", modules=("registry",), fixtures=True,
                          select=("test_stage_", "test_downloads_egress_gated"))


@pytest.mark.parametrize("case", REGISTRY_CASES)
def test_jax_registry_case_on_the_port(case, request):
    case(request)


@pytest.mark.parametrize("case", DATASET_CASES)
def test_jax_datasets_case_on_the_port(case, request):
    try:
        case(request)
    finally:
        ModelRegistry._offline = None


def test_copies_equal_jax_and_flac_native_available():
    import fluidaudio_tpu.registry as jax_registry

    assert port_registry.__all__ == jax_registry.__all__
    assert flac.native_available() is True  # the port's decoder builds here


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """An offline model cache for both packages; `stage(repo, fixture)`
    copies a trained fixture into the repo's folder."""
    monkeypatch.setenv("FLUID_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("FLUID_OFFLINE", "1")
    for reg in (JaxRegistry, ModelRegistry):
        monkeypatch.setattr(reg, "_offline", None)
        monkeypatch.setattr(reg, "_programmatic_base", None)

    def stage(repo: Repo, fixture: str):
        shutil.copytree(FIXTURES / fixture, tmp_path / "Models" / repo.folder_name)

    return stage


def utterance(seed: int, n: int, tail: float = 0.0) -> tuple[str, np.ndarray]:
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, tc.N_WORDS, size=n)
    audio = np.concatenate([tc.make_utterance(ids, rs), np.zeros(int(tail * 16000),
                                                                 np.float32)])
    return tc.transcript_text(ids), audio


@pytest.mark.parametrize("allow_random_init", [True, False])
def test_asr_models_load_reads_the_cache_as_jax(cache, allow_random_init):
    cache(Repo.PARAKEET_V3, "asr")
    truth, audio = utterance(1, 8)
    jax_models = JaxAsrModels.load("test-tiny", allow_random_init=allow_random_init)
    models = AsrModels.load("test-tiny", allow_random_init=allow_random_init, device="cpu")
    want = JaxAsrManager(jax_models, JaxASRConfig(parallel_chunk_batch=2)).transcribe(audio)
    got = AsrManager(models, ASRConfig(parallel_chunk_batch=2)).transcribe(audio)
    assert got.text == want.text == truth


def test_empty_offline_cache_raises_offline_error_in_both(cache):
    with pytest.raises(JaxOfflineError, match="encoder.npz"):
        JaxAsrModels.load("test-tiny", allow_random_init=False)
    with pytest.raises(OfflineError, match="encoder.npz"):
        AsrModels.load("test-tiny", allow_random_init=False, device="cpu")


def test_streaming_eou_reads_the_cache_as_jax(cache):
    cache(Repo.PARAKEET_EOU, "eou")
    truth, audio = utterance(2, 5, tail=1.3)
    results = []
    for mgr in (jax_eou.StreamingEouAsrManager(chunk_ms=320, spec=jax_eou.EOU_TEST),
                port_eou.StreamingEouAsrManager(chunk_ms=320, spec=port_eou.EOU_TEST,
                                                device="cpu")):
        state = mgr.make_state()
        mgr.process(audio, state)
        results.append(mgr.finish(state))
    assert results[1].text == results[0].text == truth
    assert results[1].token_ids == results[0].token_ids

    texts = []
    for ckpt in (None, FIXTURES / "eou"):
        multi = MultiStreamEouManager(1, spec=port_eou.EOU_TEST, checkpoint_dir=ckpt,
                                      device="cpu")
        multi.feed(0, audio)
        while multi.ready:
            multi.tick()
        texts.append(multi.transcript(0))
    assert texts[0] == texts[1] and texts[0]


def test_streaming_nemotron_reads_the_cache_as_jax(cache):
    cache(Repo.NEMOTRON_MULTILINGUAL, "nemotron")
    _, audio = utterance(3, 5, tail=0.6)
    texts = []
    for mgr in (jax_nem.StreamingNemotronAsrManager(jax_nem.NEMOTRON_TEST, 560,
                                                    enc_cfg=jax_eou.EOU_TEST.enc_cfg),
                port_nem.StreamingNemotronAsrManager(port_nem.NEMOTRON_TEST, 560,
                                                     enc_cfg=port_eou.EOU_TEST.enc_cfg,
                                                     device="cpu")):
        state = mgr.make_state()
        mgr.process(audio, state)
        texts.append(mgr.finish(state).text)
    assert texts[1] == texts[0] and texts[0]


def test_keyword_spotter_reads_the_cache_as_jax(cache):
    cache(Repo.PARAKEET_CTC_0_6B, "ctc")
    terms = ["w0 w3", "w5", "w1 w2"]
    rs = np.random.RandomState(4)
    seq = list(rs.randint(6, tc.N_WORDS, size=10))
    seq[2:2] = [0, 3]
    seq[7:7] = [5]
    audio = tc.make_utterance(np.asarray(seq), rs)
    jax_tok = JaxTokenizer.from_json(FIXTURES / "ctc" / "vocab.json")
    jax_spotter = JaxSpotter(
        JaxContext([JaxTerm(text=t) for t in terms], jax_tok, min_term_length=2),
        JaxKwsConfig(vocab_size=tc.N_WORDS),
        encoder_cfg=JaxConformerConfig(d_model=64, n_layers=2, n_heads=4,
                                       subsampling_channels=32, dtype="float32"))
    from fluidaudio_tpu_torch.asr.custom_vocab.context import (
        CustomVocabularyContext, VocabularyTerm,
    )
    from fluidaudio_tpu_torch.asr.keyword_spotter import CtcKeywordSpotter, KeywordSpotterConfig
    from fluidaudio_tpu_torch.asr.tokenizer import Tokenizer

    tok = Tokenizer.from_json(FIXTURES / "ctc" / "vocab.json")
    spotter = CtcKeywordSpotter(
        CustomVocabularyContext([VocabularyTerm(text=t) for t in terms], tok,
                                min_term_length=2),
        KeywordSpotterConfig(vocab_size=tc.N_WORDS), port_fx.ctc_tiny_enc_cfg(), device="cpu")
    want = sorted((s.keyword, s.start_frame, s.end_frame) for s in jax_spotter.spot(audio))
    got = sorted((s.keyword, s.start_frame, s.end_frame) for s in spotter.spot(audio))
    assert got == want and {"w0 w3", "w5"} <= {k for k, _, _ in got}
