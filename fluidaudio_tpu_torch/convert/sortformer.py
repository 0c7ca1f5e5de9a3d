"""NeMo Sortformer checkpoint -> npz param pytree for SortformerModel.

Offline converter from the upstream diar_sortformer_4spk (.nemo/.ckpt) torch
checkpoints — the source of the reference's Sortformer CoreML graphs
(`Sortformer/SortformerModelInference.swift`). Key layout:

  encoder.*                                   -> encoder (FastConformer; the
                                                 exact mapping shared with
                                                 convert/parakeet.py)
  sortformer_modules.encoder_proj             -> encoder_proj
  transformer_encoder.layers.{i}.
    first_sub_layer.{query,key,value}_net     -> tf{i}/{q,k,v}
    first_sub_layer.out_projection            -> tf{i}/out
    layer_norm_1 / layer_norm_2               -> tf{i}/ln1, tf{i}/ln2
    second_sub_layer.dense_in / dense_out     -> tf{i}/ffn_in, tf{i}/ffn_out
  sortformer_modules.first_hidden_to_hidden   -> hidden_fc
  sortformer_modules.single_hidden_to_spks    -> head
"""

from __future__ import annotations

import io
import tarfile
from pathlib import Path

import numpy as np

from fluidaudio_tpu_torch.convert.parakeet import (
    _dense,
    _ln,
    convert_conformer_encoder,
)
from fluidaudio_tpu_torch.models.conformer import ConformerConfig
from fluidaudio_tpu_torch.models.sortformer import SortformerConfig
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("convert")


def convert_sortformer_state_dict(
    sd: dict, cfg: SortformerConfig = SortformerConfig()
) -> dict:
    """torch state dict -> flax param tree for SortformerModel."""
    sd = {k: np.asarray(v) for k, v in sd.items()}

    ccfg = ConformerConfig(
        n_mels=cfg.n_mels,
        d_model=cfg.encoder_d_model,
        n_layers=cfg.n_encoder_layers,
        n_heads=cfg.n_heads,
        subsampling_channels=(256 if cfg.encoder_d_model >= 256
                              else cfg.encoder_d_model),
    )
    params: dict = {
        "encoder": convert_conformer_encoder(sd, ccfg, prefix="encoder."),
        "encoder_proj": _dense(sd, "sortformer_modules.encoder_proj"),
        "hidden_fc": _dense(sd, "sortformer_modules.first_hidden_to_hidden"),
        "head": _dense(sd, "sortformer_modules.single_hidden_to_spks"),
    }
    for i in range(cfg.n_transformer_layers):
        base = f"transformer_encoder.layers.{i}"
        params[f"tf{i}"] = {
            "q": _dense(sd, f"{base}.first_sub_layer.query_net"),
            "k": _dense(sd, f"{base}.first_sub_layer.key_net"),
            "v": _dense(sd, f"{base}.first_sub_layer.value_net"),
            "out": _dense(sd, f"{base}.first_sub_layer.out_projection"),
            "ln1": _ln(sd, f"{base}.layer_norm_1"),
            "ln2": _ln(sd, f"{base}.layer_norm_2"),
            "ffn_in": _dense(sd, f"{base}.second_sub_layer.dense_in"),
            "ffn_out": _dense(sd, f"{base}.second_sub_layer.dense_out"),
        }
    return params


def convert_sortformer_file(
    ckpt_path: str | Path, out_path: str | Path,
    cfg: SortformerConfig = SortformerConfig(),
) -> None:
    """.nemo tar or raw torch checkpoint -> sortformer.npz."""
    import torch

    from fluidaudio_tpu_torch.utils.checkpoint import save_params

    path = Path(ckpt_path)
    if tarfile.is_tarfile(path):
        with tarfile.open(path) as tar:
            member = next(m for m in tar.getmembers()
                          if m.name.endswith("model_weights.ckpt"))
            raw = torch.load(io.BytesIO(tar.extractfile(member).read()),
                             map_location="cpu", weights_only=True)
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    sd = {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in sd.items()}
    params = convert_sortformer_state_dict(sd, cfg)
    save_params(out_path, {"params": params})
    logger.info("wrote %s", out_path)
