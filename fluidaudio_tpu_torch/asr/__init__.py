from fluidaudio_tpu_torch.asr.constants import ASRConstants
from fluidaudio_tpu_torch.asr.config import (
    ASRConfig,
    ASRResult,
    TdtConfig,
    TokenTiming,
    WordTiming,
    build_word_timings,
)
from fluidaudio_tpu_torch.asr.chunk import ChunkProcessor, TokenWindow
from fluidaudio_tpu_torch.asr.tokenizer import Tokenizer

__all__ = [
    "ASRConstants",
    "ASRConfig",
    "ASRResult",
    "TdtConfig",
    "TokenTiming",
    "WordTiming",
    "build_word_timings",
    "ChunkProcessor",
    "TokenWindow",
    "Tokenizer",
    # managers import lazily (torch-heavy):
    # fluidaudio_tpu_torch.asr.manager.AsrManager
    # fluidaudio_tpu_torch.asr.streaming_eou.StreamingEouAsrManager
    # fluidaudio_tpu_torch.asr.streaming_nemotron.StreamingNemotronAsrManager
    # fluidaudio_tpu_torch.asr.multi_stream.MultiStreamEouManager
    # fluidaudio_tpu_torch.asr.sliding_window.SlidingWindowAsrManager
    # fluidaudio_tpu_torch.asr.unified.{UnifiedAsrManager,StreamingUnifiedAsrManager}
    # fluidaudio_tpu_torch.asr.keyword_spotter.CtcKeywordSpotter
]
