"""Model catalog: every model bundle the framework can load.

Behavioral parity: reference `ModelNames.swift:4-258` — a `Repo` enum of ~33
HuggingFace repos with name/remote path/subpath/folder — plus its per-family
required-model sets (`ModelNames.swift:278-700`) and the variant dispatch in
`ModelNames.getRequiredModelNames` (`ModelNames.swift:1272-1363`).

Copy of `fluidaudio_tpu/registry/model_names.py` (it imports nothing of
JAX). The checkpoints are npz parameter trees + JSON sidecars, converted
offline from the same upstream checkpoints the CoreML bundles were produced
from, and the PyTorch port reads the same files (`utils/weights.py`), so the
artifact names here are the analogs of the reference's `.mlmodelc` graph
names: one `<part>.npz` per checkpointed
sub-model, `vocab.json` / `tokenizer.json` / `metadata.json` sidecars
verbatim. Consumers (`DownloadUtils`, the `doctor` CLI, per-family loaders)
treat these as cache-relative filenames.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


@dataclass(frozen=True)
class RepoSpec:
    name: str  # HF repo id (upstream source of the weights)
    folder_name: str  # local cache folder (flat — no nesting in our cache)
    sub_path: str | None = None  # subdirectory within the repo, if any


class Repo(Enum):
    """One member per reference `Repo` case (`ModelNames.swift:4-67`).

    Latency-tier / dataset variants the reference models as distinct enum
    cases (EOU 160/320/1280 ms, Nemotron 560/1120/2240 ms, LS-EEND
    ami/ch/dih2/dih3) are distinct members here too; the un-suffixed member
    is the repo root (shared files, tier auto-selection)."""

    # --- VAD ---
    VAD = RepoSpec("FluidInference/silero-vad-coreml", "silero-vad")
    # --- Parakeet TDT batch ASR ---
    PARAKEET_V2 = RepoSpec("FluidInference/parakeet-tdt-0.6b-v2-coreml", "parakeet-v2")
    PARAKEET_V3 = RepoSpec("FluidInference/parakeet-tdt-0.6b-v3-coreml", "parakeet-v3")
    PARAKEET_TDT_CTC_110M = RepoSpec(
        "FluidInference/parakeet-tdt-ctc-110m-coreml", "parakeet-tdt-ctc-110m"
    )
    # --- Parakeet CTC ---
    PARAKEET_CTC_110M = RepoSpec(
        "FluidInference/parakeet-ctc-110m-coreml", "parakeet-ctc-110m"
    )
    PARAKEET_CTC_0_6B = RepoSpec(
        "FluidInference/parakeet-ctc-0.6b-coreml", "parakeet-ctc-0.6b"
    )
    # --- Japanese hybrid (CTC frontend + TDT decoder, ModelNames.swift:20) ---
    PARAKEET_JA = RepoSpec("FluidInference/parakeet-0.6b-ja-coreml", "parakeet-ja")
    # --- Parakeet EOU streaming (per-tier subdirs, ModelNames.swift:21-23) ---
    PARAKEET_EOU = RepoSpec(
        "FluidInference/parakeet-realtime-eou-120m-coreml", "parakeet-eou"
    )
    PARAKEET_EOU_160 = RepoSpec(
        "FluidInference/parakeet-realtime-eou-120m-coreml", "parakeet-eou-160ms", "160ms"
    )
    PARAKEET_EOU_320 = RepoSpec(
        "FluidInference/parakeet-realtime-eou-120m-coreml", "parakeet-eou-320ms", "320ms"
    )
    PARAKEET_EOU_1280 = RepoSpec(
        "FluidInference/parakeet-realtime-eou-120m-coreml", "parakeet-eou-1280ms", "1280ms"
    )
    # --- Nemotron streaming en (per-tier subdirs, ModelNames.swift:24-26) ---
    NEMOTRON_EN = RepoSpec(
        "FluidInference/nemotron-speech-streaming-en-0.6b-coreml", "nemotron-en"
    )
    NEMOTRON_EN_560 = RepoSpec(
        "FluidInference/nemotron-speech-streaming-en-0.6b-coreml",
        "nemotron-en-560ms", "nemotron_coreml_560ms",
    )
    NEMOTRON_EN_1120 = RepoSpec(
        "FluidInference/nemotron-speech-streaming-en-0.6b-coreml",
        "nemotron-en-1120ms", "nemotron_coreml_1120ms",
    )
    NEMOTRON_EN_2240 = RepoSpec(
        "FluidInference/nemotron-speech-streaming-en-0.6b-coreml",
        "nemotron-en-2240ms", "nemotron_coreml_2240ms",
    )
    NEMOTRON_MULTILINGUAL = RepoSpec(
        "FluidInference/Nemotron-3.5-ASR-Streaming-Multilingual-0.6b-CoreML",
        "nemotron-multilingual",
    )
    # --- Unified batch/streaming (ModelNames.swift:31) ---
    PARAKEET_UNIFIED = RepoSpec(
        "FluidInference/parakeet-unified-en-0.6b-coreml", "parakeet-unified"
    )
    # --- Other ASR families ---
    SENSEVOICE = RepoSpec("FluidInference/sensevoice-small-coreml", "sensevoice")
    PARAFORMER = RepoSpec("FluidInference/paraformer-large-zh-coreml", "paraformer-zh")
    COHERE = RepoSpec(
        "FluidInference/cohere-transcribe-03-2026-coreml", "cohere-transcribe-q8", "q8"
    )
    # --- Diarization ---
    DIARIZER = RepoSpec("FluidInference/speaker-diarization-coreml", "diarizer")
    # The reference fetches the offline (VBx) model set from the same repo
    # under variant "offline" (`ModelNames.swift:1311-1315`); our cache keeps
    # it in its own folder so online/offline sets never collide.
    OFFLINE_DIARIZER = RepoSpec(
        "FluidInference/speaker-diarization-coreml", "offline-diarizer"
    )
    SORTFORMER = RepoSpec(
        "FluidInference/diar-streaming-sortformer-coreml", "sortformer"
    )
    LS_EEND = RepoSpec("FluidInference/ls-eend-coreml", "ls-eend")
    LS_EEND_AMI = RepoSpec(
        "FluidInference/ls-eend-coreml", "ls-eend-ami", "optimized/ami"
    )
    LS_EEND_CALLHOME = RepoSpec(
        "FluidInference/ls-eend-coreml", "ls-eend-ch", "optimized/ch"
    )
    LS_EEND_DIHARD2 = RepoSpec(
        "FluidInference/ls-eend-coreml", "ls-eend-dih2", "optimized/dih2"
    )
    LS_EEND_DIHARD3 = RepoSpec(
        "FluidInference/ls-eend-coreml", "ls-eend-dih3", "optimized/dih3"
    )
    # --- TTS ---
    # Repo root: shared Kokoro G2P assets (the mono backend was removed
    # upstream; `ModelNames.swift:40-44`).
    KOKORO = RepoSpec("FluidInference/kokoro-82m-coreml", "kokoro")
    KOKORO_ANE = RepoSpec("FluidInference/kokoro-82m-coreml", "kokoro-ane", "ANE")
    KOKORO_ANE_ZH = RepoSpec(
        "FluidInference/kokoro-82m-coreml", "kokoro-ane-zh", "ANE-zh"
    )
    KOKORO_ANE_JA = RepoSpec(
        "FluidInference/kokoro-82m-coreml", "kokoro-ane-ja", "ANE-ja"
    )
    POCKET_TTS = RepoSpec("FluidInference/pocket-tts-coreml", "pocket-tts")
    STYLETTS2 = RepoSpec(
        "FluidInference/StyleTTS-2-coreml", "styletts2", "iteration_3/compiled"
    )
    SUPERTONIC3 = RepoSpec("FluidInference/supertonic-3-coreml", "supertonic-3")
    # --- G2P ---
    CHARSIU_G2P = RepoSpec("FluidInference/charsiu-g2p-byt5-coreml", "charsiu-g2p")

    @property
    def spec(self) -> RepoSpec:
        return self.value

    @property
    def folder_name(self) -> str:
        return self.value.folder_name

    @property
    def remote_path(self) -> str:
        return self.value.name

    @property
    def sub_path(self) -> str | None:
        return self.value.sub_path


# --------------------------------------------------------------------------
# Per-family artifact-name namespaces (the reference's `ModelNames.X` enums).
# Each constant is a cache-relative filename inside the repo's folder.
# --------------------------------------------------------------------------

TDT_PARTS = ("encoder.npz", "predictor.npz", "joint.npz")
TDT_VOCAB = "vocab.json"

VAD_MODEL = "silero_vad.npz"

CTC_PARTS = ("encoder.npz",)  # mel frontend is computed natively (ops/mel.py)
CTC_VOCAB = "vocab.json"

SENSEVOICE_PARTS = ("encoder.npz",)  # LFR frontend native; encoder = SANM stack
SENSEVOICE_VOCAB = "vocab.json"  # 25055 SentencePiece tokens

PARAFORMER_PARTS = ("encoder.npz", "cif.npz", "decoder.npz")
PARAFORMER_VOCAB = "vocab.json"  # 8404 CharTokenizer tokens

COHERE_PARTS = ("encoder.npz", "decoder.npz")
COHERE_TOKENIZER = "tokenizer.json"

EOU_PARTS = ("encoder.npz", "predictor.npz", "joint.npz")  # fused frontend
EOU_VOCAB = "vocab.json"

NEMOTRON_PARTS = ("encoder.npz", "predictor.npz", "joint.npz")
NEMOTRON_SIDE = ("tokenizer.json", "metadata.json")

UNIFIED_STREAMING = ("encoder_streaming.npz",)
UNIFIED_OFFLINE = ("encoder.npz",)
UNIFIED_SHARED = ("predictor.npz", "joint.npz", "vocab.json", "metadata.json")

DIARIZER_PARTS = ("segmentation.npz", "embedding.npz")
OFFLINE_DIARIZER_PARTS = (
    "segmentation.npz",
    "fbank.npz",
    "embedding.npz",
    "plda_rho.npz",
    "plda-parameters.json",
)
SORTFORMER_PARTS = ("encoder.npz",)
LSEEND_PARTS = ("model.npz",)

KOKORO_ANE_PARTS = (
    "albert.npz",
    "post_albert.npz",
    "alignment.npz",
    "prosody.npz",
    "noise.npz",
    "vocoder.npz",
    "tail_istft.npz",
    "voices.npz",
    "vocab.json",
)
POCKET_TTS_PARTS = (
    "cond_prefill.npz",
    "flowlm_step.npz",
    "flow_decoder_fused.npz",
    "mimi_decoder.npz",
    "tokenizer.json",
)
STYLETTS2_PARTS = (
    "bert.npz",
    "predictor.npz",
    "text_encoder.npz",
    "style_diffusion.npz",
    "decoder.npz",
    "voices.npz",
    "vocab.json",
)
STYLETTS2_BUCKETS = (64, 128, 256)
SUPERTONIC3_PARTS = (
    "text_encoder.npz",
    "duration_predictor.npz",
    "vector_estimator.npz",
    "vocoder.npz",
    "tts.json",
    "unicode_indexer.json",
)
G2P_PARTS = ("bart.npz", "vocab.json")  # Kokoro-root BART G2P assets
CHARSIU_PARTS = ("byt5.npz", "vocab.json")


def _styletts2_bucket(t: int) -> tuple[str, ...]:
    return (f"predictor_t{t}.npz", f"decoder_t{t}.npz")


# --------------------------------------------------------------------------
# Variant-aware required-model dispatch (ModelNames.swift:1272-1363).
# --------------------------------------------------------------------------


def required_models(repo: Repo, variant: str | None = None) -> tuple[str, ...]:
    """Cache-relative filenames a family's loader needs before it can run.

    `variant` mirrors the reference's variant strings: ASR precision
    ("int8"), SenseVoice precision ("int8"/"fp32"), unified
    ("offline"/"offline-fp16"/"fp16"), diarizer ("offline"), StyleTTS2
    ("all"/"t64"/"t128"/"t256"), LS-EEND / Sortformer explicit model names.
    """
    if repo in (Repo.PARAKEET_V2, Repo.PARAKEET_V3, Repo.PARAKEET_JA,
                Repo.PARAKEET_TDT_CTC_110M):
        # int8 is quantize-at-load from the same f32 npz (ops/quant.py), so
        # unlike the reference's EncoderInt4 bundle there is no precision
        # variant file. parakeet-ja is the hybrid layout: CTC-trained
        # encoder + TDT decoder/joint from one repo (ModelNames.swift:462-470).
        return TDT_PARTS + (TDT_VOCAB,)
    if repo in (Repo.PARAKEET_CTC_110M, Repo.PARAKEET_CTC_0_6B):
        return CTC_PARTS + (CTC_VOCAB,)
    if repo is Repo.VAD:
        return (VAD_MODEL,)
    if repo is Repo.SENSEVOICE:
        # precision selects quantize-at-load; the artifact set is constant
        return SENSEVOICE_PARTS + (SENSEVOICE_VOCAB,)
    if repo is Repo.PARAFORMER:
        return PARAFORMER_PARTS + (PARAFORMER_VOCAB,)
    if repo is Repo.COHERE:
        return COHERE_PARTS + (COHERE_TOKENIZER,)
    if repo in (Repo.PARAKEET_EOU, Repo.PARAKEET_EOU_160, Repo.PARAKEET_EOU_320,
                Repo.PARAKEET_EOU_1280):
        return EOU_PARTS + (EOU_VOCAB,)
    if repo in (Repo.NEMOTRON_EN, Repo.NEMOTRON_EN_560, Repo.NEMOTRON_EN_1120,
                Repo.NEMOTRON_EN_2240, Repo.NEMOTRON_MULTILINGUAL):
        return NEMOTRON_PARTS + NEMOTRON_SIDE
    if repo is Repo.PARAKEET_UNIFIED:
        is_offline = bool(variant) and variant.startswith("offline")
        enc = UNIFIED_OFFLINE if is_offline else UNIFIED_STREAMING
        return enc + UNIFIED_SHARED
    if repo is Repo.DIARIZER:
        if variant == "offline":
            return OFFLINE_DIARIZER_PARTS
        return DIARIZER_PARTS
    if repo is Repo.OFFLINE_DIARIZER:
        return OFFLINE_DIARIZER_PARTS
    if repo is Repo.SORTFORMER:
        if variant:
            return (f"{variant}.npz",)
        return SORTFORMER_PARTS
    if repo in (Repo.LS_EEND, Repo.LS_EEND_AMI, Repo.LS_EEND_CALLHOME,
                Repo.LS_EEND_DIHARD2, Repo.LS_EEND_DIHARD3):
        if variant:
            return (f"{variant}.npz",)
        return LSEEND_PARTS
    if repo is Repo.KOKORO:
        return G2P_PARTS
    if repo in (Repo.KOKORO_ANE, Repo.KOKORO_ANE_ZH, Repo.KOKORO_ANE_JA):
        return KOKORO_ANE_PARTS
    if repo is Repo.POCKET_TTS:
        return POCKET_TTS_PARTS
    if repo is Repo.STYLETTS2:
        if variant == "all":
            extra: tuple[str, ...] = ()
            for t in STYLETTS2_BUCKETS:
                extra += _styletts2_bucket(t)
            return STYLETTS2_PARTS + extra
        if variant and variant.startswith("t") and variant[1:].isdigit():
            return _styletts2_bucket(int(variant[1:]))
        return STYLETTS2_PARTS
    if repo is Repo.SUPERTONIC3:
        return SUPERTONIC3_PARTS
    if repo is Repo.CHARSIU_G2P:
        return CHARSIU_PARTS
    return ()


# --------------------------------------------------------------------------
# Family metadata for the readiness report (`doctor` CLI).
# --------------------------------------------------------------------------

#: workload family -> (display name, repos that family can load from)
FAMILIES: dict[str, tuple[str, tuple[Repo, ...]]] = {
    "vad": ("Voice activity detection (Silero)", (Repo.VAD,)),
    "asr-tdt": (
        "Parakeet TDT batch ASR",
        (Repo.PARAKEET_V3, Repo.PARAKEET_V2, Repo.PARAKEET_TDT_CTC_110M,
         Repo.PARAKEET_JA),
    ),
    "asr-ctc": (
        "Parakeet CTC ASR (keyword spotting / LM decode)",
        (Repo.PARAKEET_CTC_110M, Repo.PARAKEET_CTC_0_6B),
    ),
    "asr-eou": (
        "Streaming EOU ASR",
        (Repo.PARAKEET_EOU, Repo.PARAKEET_EOU_160, Repo.PARAKEET_EOU_320,
         Repo.PARAKEET_EOU_1280),
    ),
    "asr-nemotron": (
        "Nemotron streaming ASR",
        (Repo.NEMOTRON_EN, Repo.NEMOTRON_EN_560, Repo.NEMOTRON_EN_1120,
         Repo.NEMOTRON_EN_2240, Repo.NEMOTRON_MULTILINGUAL),
    ),
    "asr-unified": ("Parakeet unified batch/streaming", (Repo.PARAKEET_UNIFIED,)),
    "asr-sensevoice": ("SenseVoice small", (Repo.SENSEVOICE,)),
    "asr-paraformer": ("Paraformer-large zh", (Repo.PARAFORMER,)),
    "asr-cohere": ("Cohere transcribe", (Repo.COHERE,)),
    "diarizer-online": ("Online pyannote diarizer", (Repo.DIARIZER,)),
    "diarizer-offline": ("Offline VBx diarizer", (Repo.OFFLINE_DIARIZER,)),
    "diarizer-sortformer": ("Sortformer streaming diarizer", (Repo.SORTFORMER,)),
    "diarizer-lseend": (
        "LS-EEND online diarizer",
        (Repo.LS_EEND, Repo.LS_EEND_AMI, Repo.LS_EEND_CALLHOME,
         Repo.LS_EEND_DIHARD2, Repo.LS_EEND_DIHARD3),
    ),
    "tts-kokoro": (
        "Kokoro TTS",
        (Repo.KOKORO_ANE, Repo.KOKORO_ANE_ZH, Repo.KOKORO_ANE_JA, Repo.KOKORO),
    ),
    "tts-pocket": ("PocketTTS (flow-LM + Mimi)", (Repo.POCKET_TTS,)),
    "tts-styletts2": ("StyleTTS2", (Repo.STYLETTS2,)),
    "tts-supertonic": ("Supertonic-3", (Repo.SUPERTONIC3,)),
    "g2p": ("Multilingual G2P (ByT5)", (Repo.CHARSIU_G2P,)),
}
