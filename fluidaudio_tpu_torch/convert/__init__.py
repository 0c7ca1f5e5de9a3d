"""Offline checkpoint converters: upstream checkpoints -> npz param trees.

Numpy copies of the JAX package's converters (`fluidaudio_tpu/convert/`),
their imports pointed at the port's configs: each reads an upstream
checkpoint (a NeMo `.nemo` tar or raw ckpt, FunASR, pyannote and WeSpeaker
`.bin`/`.ckpt`, `silero_vad.jit`, HF T5/BART/BERT state dicts, Kokoro,
StyleTTS2, PocketTTS/Mimi, Supertonic-3's ONNX release) and returns the
param tree in the layout the JAX package saves ("flax" in the modules'
docstrings names that layout), which `utils/checkpoint.save_params` writes
with JAX's keys and `utils/weights.load_npz` maps onto the port's modules.
They run on the host in numpy, so they give JAX's arrays bit for bit.

    python -c "from fluidaudio_tpu_torch.convert import convert_nemo_file; \
        from fluidaudio_tpu_torch.models.zoo import ASR_VERSIONS as V; \
        convert_nemo_file('parakeet-tdt-0.6b-v3.nemo', 'out', V['v3'].conformer, V['v3'].predictor)"
"""

from fluidaudio_tpu_torch.convert.parakeet import (
    convert_parakeet_state_dict,
    convert_nemo_file,
)
from fluidaudio_tpu_torch.convert.wespeaker import (
    convert_wespeaker_state_dict,
    convert_wespeaker_file,
)
from fluidaudio_tpu_torch.convert.paraformer import (
    convert_paraformer_state_dict,
    convert_paraformer_file,
)
from fluidaudio_tpu_torch.convert.sensevoice import (
    convert_sensevoice_state_dict,
    convert_sensevoice_file,
)
from fluidaudio_tpu_torch.convert.sortformer import (
    convert_sortformer_state_dict,
    convert_sortformer_file,
)
from fluidaudio_tpu_torch.convert.silero import (
    convert_silero_state_dict,
    convert_silero_file,
)
from fluidaudio_tpu_torch.convert.pyannote import (
    convert_pyannote_state_dict,
    convert_pyannote_file,
    materialize_sinc_filters,
)

__all__ = [
    "convert_parakeet_state_dict",
    "convert_nemo_file",
    "convert_wespeaker_state_dict",
    "convert_wespeaker_file",
    "convert_pyannote_state_dict",
    "convert_pyannote_file",
    "materialize_sinc_filters",
    "convert_silero_state_dict",
    "convert_silero_file",
    "convert_sortformer_state_dict",
    "convert_sortformer_file",
    "convert_sensevoice_state_dict",
    "convert_sensevoice_file",
    "convert_paraformer_state_dict",
    "convert_paraformer_file",
]
