from fluidaudio_tpu_torch.utils.logging import get_logger
from fluidaudio_tpu_torch.utils.audio_io import read_audio, read_wav, write_wav
from fluidaudio_tpu_torch.utils.converter import AudioConverter
from fluidaudio_tpu_torch.utils.audio_source import (
    ArrayAudioSource,
    AudioSampleSource,
    DiskBackedAudioSampleSource,
    make_audio_source,
)
from fluidaudio_tpu_torch.utils.timing import StageTimer, PerformanceMetrics, ProgressEmitter

__all__ = [
    "get_logger",
    "read_audio",
    "read_wav",
    "write_wav",
    "AudioConverter",
    "AudioSampleSource",
    "ArrayAudioSource",
    "DiskBackedAudioSampleSource",
    "make_audio_source",
    "StageTimer",
    "PerformanceMetrics",
    "ProgressEmitter",
]
