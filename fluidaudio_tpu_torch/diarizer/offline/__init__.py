from fluidaudio_tpu_torch.diarizer.offline.types import OfflineDiarizerConfig, SpeakerCountConstraints, total_chunks
from fluidaudio_tpu_torch.diarizer.offline.manager import OfflineDiarizerManager

__all__ = ["OfflineDiarizerConfig", "OfflineDiarizerManager", "SpeakerCountConstraints", "total_chunks"]
