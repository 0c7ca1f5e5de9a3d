from fluidaudio_tpu_torch.models.conformer import ConformerConfig, ConformerEncoder
from fluidaudio_tpu_torch.models.predictor import PredictorConfig, RnntPredictor, RnntJoint

__all__ = [
    "ConformerConfig",
    "ConformerEncoder",
    "PredictorConfig",
    "RnntPredictor",
    "RnntJoint",
]
