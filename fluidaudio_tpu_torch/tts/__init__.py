from fluidaudio_tpu_torch.tts.kokoro_manager import KokoroManager, KokoroSynthesisResult
from fluidaudio_tpu_torch.tts.roundtrip import tts_asr_roundtrip
from fluidaudio_tpu_torch.tts.ssml import (
    SSMLProcessingResult,
    SSMLProcessor,
    TtsPhoneticOverride,
    process_ssml,
)
from fluidaudio_tpu_torch.tts.text_normalizer import english_normalize, normalize_for_tts

__all__ = [
    "KokoroManager",
    "KokoroSynthesisResult",
    # not ported yet: PocketTtsManager, StyleTTS2Manager, Supertonic3Manager
    "tts_asr_roundtrip",
    "SSMLProcessor",
    "english_normalize",
    "normalize_for_tts",
]
