"""Public surface of the PyTorch port against `tests/test_public_api.py`.

Each entry of the JAX package's documented surface whose module is ported
has its `fluidaudio_tpu_torch.` counterpart, named here one by one (the
entries still missing are listed in ROADMAP.md). Each ported subpackage's
`__init__` re-exports the names the JAX `__init__` exports, less the
names of modules not ported yet, listed here.
"""

import importlib

import pytest

from tests.test_public_api import PUBLIC_API
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

# the port's counterpart of every ported entry of PUBLIC_API
PORTED = [
    ("fluidaudio_tpu_torch.models.zoo", "AsrModels"),
    ("fluidaudio_tpu_torch.asr.manager", "AsrManager"),
    ("fluidaudio_tpu_torch.asr.config", "ASRConfig"),
    ("fluidaudio_tpu_torch.asr.config", "TdtConfig"),
    ("fluidaudio_tpu_torch.asr.chunk", "ChunkProcessor"),
    ("fluidaudio_tpu_torch.asr.sliding_window", "SlidingWindowAsrManager"),
    ("fluidaudio_tpu_torch.asr.streaming_eou", "StreamingEouAsrManager"),
    ("fluidaudio_tpu_torch.asr.streaming_nemotron", "StreamingNemotronAsrManager"),
    ("fluidaudio_tpu_torch.asr.streaming_variants", "create_streaming_manager"),
    ("fluidaudio_tpu_torch.asr.unified", "UnifiedAsrManager"),
    ("fluidaudio_tpu_torch.asr.unified", "StreamingUnifiedAsrManager"),
    ("fluidaudio_tpu_torch.asr.multi_stream", "MultiStreamEouManager"),
    ("fluidaudio_tpu_torch.asr.arbitration", "arbitrate"),
    ("fluidaudio_tpu_torch.asr.keyword_spotter", "CtcKeywordSpotter"),
    ("fluidaudio_tpu_torch.asr.custom_vocab.context", "CustomVocabularyContext"),
    ("fluidaudio_tpu_torch.asr.custom_vocab.rescorer", "VocabularyRescorer"),
    ("fluidaudio_tpu_torch.asr.punctuation_commit", "PunctuationCommitLayer"),
    ("fluidaudio_tpu_torch.asr.sensevoice_manager", "SenseVoiceManager"),
    ("fluidaudio_tpu_torch.asr.paraformer_manager", "ParaformerManager"),
    ("fluidaudio_tpu_torch.asr.cohere_manager", "CoherePipeline"),
    ("fluidaudio_tpu_torch.vad.manager", "VadManager"),
    ("fluidaudio_tpu_torch.vad.types", "VadConfig"),
    ("fluidaudio_tpu_torch.vad.types", "VadSegmentationConfig"),
    ("fluidaudio_tpu_torch.registry", "ModelRegistry"),
    ("fluidaudio_tpu_torch.registry", "DownloadUtils"),
    ("fluidaudio_tpu_torch.registry", "Repo"),
    ("fluidaudio_tpu_torch.utils.converter", "AudioConverter"),
    ("fluidaudio_tpu_torch.utils.audio_stream", "AudioStream"),
    ("fluidaudio_tpu_torch.utils.language", "TokenLanguageFilter"),
    ("fluidaudio_tpu_torch.ops.tdt_decode", "tdt_greedy_decode"),
    ("fluidaudio_tpu_torch.ops.mel", "MelFrontend"),
    ("fluidaudio_tpu_torch.metrics.wer", "wer"),
    ("fluidaudio_tpu_torch.diarizer.manager", "DiarizerManager"),
    ("fluidaudio_tpu_torch.diarizer.offline.manager", "OfflineDiarizerManager"),
    ("fluidaudio_tpu_torch.diarizer.offline.types", "OfflineDiarizerConfig"),
    ("fluidaudio_tpu_torch.diarizer.sortformer", "SortformerDiarizer"),
    ("fluidaudio_tpu_torch.diarizer.timeline", "DiarizerTimeline"),
    ("fluidaudio_tpu_torch.diarizer.speaker_manager", "SpeakerManager"),
    ("fluidaudio_tpu_torch.diarizer.speaker_id", "SpeakerVerifier"),
    ("fluidaudio_tpu_torch.diarizer.metrics", "compute_der"),
    ("fluidaudio_tpu_torch.diarizer.lseend", "LSEENDDiarizer"),
    ("fluidaudio_tpu_torch.tts.kokoro_manager", "KokoroManager"),
    ("fluidaudio_tpu_torch.tts.pocket_manager", "PocketTtsManager"),
    ("fluidaudio_tpu_torch.tts.styletts2_manager", "StyleTTS2Manager"),
    ("fluidaudio_tpu_torch.tts.supertonic_manager", "Supertonic3Manager"),
    ("fluidaudio_tpu_torch.tts.g2p", "EnglishG2P"),
    ("fluidaudio_tpu_torch.tts.g2p", "MultilingualG2P"),
    ("fluidaudio_tpu_torch.tts.mandarin_g2p", "MandarinG2P"),
    ("fluidaudio_tpu_torch.tts.mandarin_g2p", "MandarinJiebaHmm"),
    ("fluidaudio_tpu_torch.tts.ssml", "SSMLProcessor"),
    ("fluidaudio_tpu_torch.tts.roundtrip", "tts_asr_roundtrip"),
    ("fluidaudio_tpu_torch.itn", "TextNormalizer"),
    ("fluidaudio_tpu_torch.utils.chunk_queue", "StreamingChunkQueue"),
]


@pytest.mark.parametrize("module,attr", PORTED, ids=[f"{m}.{a}" for m, a in PORTED])
def test_ported_public_symbol_importable(module, attr):
    jax_module = "fluidaudio_tpu." + module.removeprefix("fluidaudio_tpu_torch.")
    assert (jax_module, attr) in PUBLIC_API
    assert hasattr(importlib.import_module(module), attr), f"{module}.{attr} missing"


# names a JAX subpackage exports from modules the port does not have yet
NOT_PORTED = {
    "asr": set(),
    "ops": set(),
    "models": set(),
    "utils": set(),
    "metrics": set(),
    "registry": set(),
    "vad": set(),
    "asr.custom_vocab": set(),
    "diarizer": set(),
    "diarizer.offline": set(),
    "tts": set(),
    "itn": set(),
}


@pytest.mark.parametrize("package", list(NOT_PORTED))
def test_subpackage_reexports_what_jax_exports(package):
    jax_pkg = importlib.import_module(f"fluidaudio_tpu.{package}")
    port_pkg = importlib.import_module(f"fluidaudio_tpu_torch.{package}")
    want = set(getattr(jax_pkg, "__all__", None) or
               [n for n in vars(jax_pkg) if not n.startswith("_")
                and not isinstance(vars(jax_pkg)[n], type(jax_pkg))])
    names = set(getattr(port_pkg, "__all__", None) or
                [n for n in vars(port_pkg) if not n.startswith("_")
                 and not isinstance(vars(port_pkg)[n], type(port_pkg))])
    assert names == want - NOT_PORTED[package]
    for name in names:
        assert hasattr(port_pkg, name), f"fluidaudio_tpu_torch.{package}.{name}"


def test_default_config_and_version():
    from fluidaudio_tpu_torch import __version__
    from fluidaudio_tpu_torch.asr import ASRConfig
    from fluidaudio_tpu_torch.ops import log_mel_numpy  # noqa: F401
    from fluidaudio_tpu_torch.utils import read_audio  # noqa: F401

    ASRConfig()
    assert __version__


def test_only_the_parallel_mesh_is_missing():
    """Every entry of the JAX package's documented surface has its port
    counterpart in PORTED but `parallel.mesh.make_mesh` (ROADMAP item 7)."""
    ported = {("fluidaudio_tpu." + m.removeprefix("fluidaudio_tpu_torch."), a) for m, a in PORTED}
    assert set(PUBLIC_API) - ported == {("fluidaudio_tpu.parallel.mesh", "make_mesh")}
