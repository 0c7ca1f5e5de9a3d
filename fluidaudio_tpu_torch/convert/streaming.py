"""NeMo cache-aware streaming FastConformer checkpoint -> flax tree for
models/conformer_streaming.StreamingConformerEncoder.

The upstream streaming checkpoints (parakeet_realtime_eou 120M, nemotron
streaming) use the SAME NeMo encoder key names as the offline models
(`encoder.pre_encode.*`, `encoder.layers.{i}.*`), so this reuses
convert/parakeet.convert_conformer_encoder verbatim; the only structural
difference is that the streaming module keeps its subsampling convs at the
top level (stem/dw0/pw0/dw1/pw1/proj) instead of under a "subsampling"
submodule. The predictor/joint of an EOU checkpoint map with the same
helpers as the Parakeet converter.
"""

from __future__ import annotations

import numpy as np

from fluidaudio_tpu_torch.convert.parakeet import convert_conformer_encoder
from fluidaudio_tpu_torch.models.conformer import ConformerConfig
from fluidaudio_tpu_torch.models.conformer_streaming import StreamingConformerConfig


def convert_streaming_conformer_state_dict(
    sd: dict, cfg: StreamingConformerConfig, prefix: str = "encoder."
) -> dict:
    """torch state dict -> flax param tree for StreamingConformerEncoder."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    ccfg = ConformerConfig(
        n_mels=cfg.n_mels,
        d_model=cfg.d_model,
        n_layers=cfg.n_layers,
        n_heads=cfg.n_heads,
        ffn_expansion=cfg.ffn_expansion,
        conv_kernel=cfg.conv_kernel,
        subsampling_channels=cfg.subsampling_channels,
    )
    enc = convert_conformer_encoder(sd, ccfg, prefix=prefix)
    sub = enc.pop("subsampling")
    enc.update(sub)  # streaming module keeps subsampling convs at top level
    return enc
