from fluidaudio_tpu_torch.ops.mel import MelConfig, MelFrontend, log_mel_numpy

__all__ = ["MelConfig", "MelFrontend", "log_mel_numpy"]
