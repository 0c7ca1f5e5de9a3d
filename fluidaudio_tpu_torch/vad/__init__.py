from fluidaudio_tpu_torch.vad.types import (
    VadConfig,
    VadResult,
    VadSegment,
    VadSegmentationConfig,
    VadStreamEvent,
    VadStreamResult,
    VadStreamState,
)
from fluidaudio_tpu_torch.vad.manager import VadManager

__all__ = [
    "VadConfig",
    "VadResult",
    "VadSegment",
    "VadSegmentationConfig",
    "VadStreamEvent",
    "VadStreamResult",
    "VadStreamState",
    "VadManager",
]
