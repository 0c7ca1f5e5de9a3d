"""FunASR Paraformer checkpoint -> npz param pytree for models/paraformer.

Offline converter from the upstream FunASR torch checkpoint — the source of
the reference's Paraformer CoreML graphs (`Paraformer/ParaformerManager.swift`).
Key layout (funasr Paraformer / SANMEncoder / ParaformerSANMDecoder):

  encoder.encoders0.0.* / encoder.encoders.{i}.*   -> enc0 / enc{i}
                                                       (same SANM block map as
                                                       convert/sensevoice.py)
  encoder.after_norm                               -> enc_ln
  predictor.cif_conv1d / cif_output                -> cif/conv, cif/alpha_head
  decoder.decoders.{i}.
    self_attn.fsmn_block.weight [D,1,k]            -> dec{i}/fsmn
    src_attn.linear_q                              -> dec{i}/q
    src_attn.linear_k_v (fused [2D, D])            -> dec{i}/kv
    src_attn.linear_out                            -> dec{i}/out
    feed_forward.w_1 / norm / w_2 (w_2 bias-free)  -> dec{i}/ffn/{ffn1,ffn_norm,ffn2}
    norm1 / norm2 / norm3                          -> dec{i}/norm{1,2,3}
  decoder.decoders3.0.feed_forward.* / norm1       -> dec3_ffn / dec3_norm1
  decoder.after_norm                               -> dec_ln
  decoder.output_layer                             -> head
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fluidaudio_tpu_torch.convert.sensevoice import _block, _dense, _ln
from fluidaudio_tpu_torch.models.paraformer import ParaformerConfig
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("convert")


def _ffn(sd: dict, base: str) -> dict:
    return {
        "ffn1": _dense(sd, f"{base}.w_1"),
        "ffn_norm": _ln(sd, f"{base}.norm"),
        "ffn2": {"kernel": np.asarray(sd[f"{base}.w_2.weight"], np.float32).T},
    }


def convert_paraformer_state_dict(
    sd: dict, cfg: ParaformerConfig = ParaformerConfig()
) -> dict:
    """torch state dict -> flax param tree for Paraformer."""
    sd = {k: np.asarray(v) for k, v in sd.items()}

    params: dict = {
        "enc0": _block(sd, "encoder.encoders0.0"),
        "enc_ln": _ln(sd, "encoder.after_norm"),
        "dec_ln": _ln(sd, "decoder.after_norm"),
        "head": _dense(sd, "decoder.output_layer"),
        "dec3_norm1": _ln(sd, "decoder.decoders3.0.norm1"),
        "dec3_ffn": _ffn(sd, "decoder.decoders3.0.feed_forward"),
    }
    for i in range(1, cfg.n_encoder_layers):
        params[f"enc{i}"] = _block(sd, f"encoder.encoders.{i - 1}")

    cif_w = np.asarray(sd["predictor.cif_conv1d.weight"], np.float32)  # [O,I,k]
    params["cif"] = {
        "conv": {"kernel": np.transpose(cif_w, (2, 1, 0)),
                 "bias": np.asarray(sd["predictor.cif_conv1d.bias"], np.float32)},
        "alpha_head": _dense(sd, "predictor.cif_output"),
    }

    for i in range(cfg.n_decoder_layers):
        b = f"decoder.decoders.{i}"
        fsmn = np.asarray(sd[f"{b}.self_attn.fsmn_block.weight"], np.float32)
        params[f"dec{i}"] = {
            "norm1": _ln(sd, f"{b}.norm1"),
            "fsmn": {"kernel": np.transpose(fsmn, (2, 1, 0))},
            "norm2": _ln(sd, f"{b}.norm2"),
            "q": _dense(sd, f"{b}.src_attn.linear_q"),
            "kv": _dense(sd, f"{b}.src_attn.linear_k_v"),
            "out": _dense(sd, f"{b}.src_attn.linear_out"),
            "norm3": _ln(sd, f"{b}.norm3"),
            "ffn": _ffn(sd, f"{b}.feed_forward"),
        }
    return params


def convert_paraformer_file(
    ckpt_path: str | Path, out_path: str | Path,
    cfg: ParaformerConfig = ParaformerConfig(),
) -> None:
    """model.pt -> paraformer.npz."""
    import torch

    from fluidaudio_tpu_torch.utils.checkpoint import save_params

    raw = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    sd = {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in sd.items()}
    params = convert_paraformer_state_dict(sd, cfg)
    save_params(out_path, {"params": params})
    logger.info("wrote %s", out_path)
