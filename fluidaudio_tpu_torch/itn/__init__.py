from fluidaudio_tpu_torch.itn.normalizer import TextNormalizer

__all__ = ["TextNormalizer"]
