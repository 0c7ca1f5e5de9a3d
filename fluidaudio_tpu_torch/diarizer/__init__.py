from fluidaudio_tpu_torch.diarizer.types import (
    DiarizerConfig,
    DiarizationResult,
    PipelineTimings,
    RawEmbedding,
    Speaker,
    TimedSpeakerSegment,
)
from fluidaudio_tpu_torch.diarizer.speaker_manager import SpeakerManager
from fluidaudio_tpu_torch.diarizer.manager import DiarizerManager
from fluidaudio_tpu_torch.diarizer.timeline import DiarizerTimeline, TimelineConfig
from fluidaudio_tpu_torch.diarizer.metrics import compute_der, DerResult

__all__ = [
    "DiarizerConfig",
    "DiarizationResult",
    "PipelineTimings",
    "RawEmbedding",
    "Speaker",
    "TimedSpeakerSegment",
    "SpeakerManager",
    "DiarizerManager",
    "DiarizerTimeline",
    "TimelineConfig",
    "compute_der",
    "DerResult",
]
