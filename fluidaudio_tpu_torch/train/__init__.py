"""See the package docstring of `fluidaudio_tpu_torch`."""

from fluidaudio_tpu_torch.train.transducer_loss import rnnt_loss, tdt_loss

__all__ = ["rnnt_loss", "tdt_loss"]
