"""FunASR SenseVoiceSmall checkpoint -> npz param pytree for SenseVoiceEncoder.

Offline converter from the upstream FunASR torch checkpoint — the source of
the reference's SenseVoice CoreML graphs (`SenseVoice/SenseVoiceManager.swift`).
Key layout (funasr SenseVoiceSmall / SANM encoder):

  embed.weight [n_special, 560]                      -> embed
  encoder.encoders0.0.*                              -> block0 (in_size 560)
  encoder.encoders.{i}.*                             -> block{i+1}
    self_attn.linear_q_k_v                           -> qkv (fused)
    self_attn.fsmn_block.weight [D, 1, k]            -> fsmn kernel [k, 1, D]
    self_attn.linear_out                             -> out
    feed_forward.w_1 / w_2                           -> ffn1 / ffn2
    norm1 / norm2                                    -> norm1 / norm2
  encoder.after_norm                                 -> final_ln
  ctc.ctc_lo                                         -> ctc_head

Note: SenseVoiceSmall also carries a timestamp-predictor stack
(`encoder.tp_encoders.*` + `encoder.tp_norm`) not modeled here; mapping it is
deferred to the real-weights round (TODO.md).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fluidaudio_tpu_torch.models.sensevoice import SenseVoiceConfig
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("convert")


def _dense(sd: dict, key: str) -> dict:
    out = {"kernel": np.asarray(sd[f"{key}.weight"], np.float32).T}
    if f"{key}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{key}.bias"], np.float32)
    return out


def _ln(sd: dict, key: str) -> dict:
    return {"scale": np.asarray(sd[f"{key}.weight"], np.float32),
            "bias": np.asarray(sd[f"{key}.bias"], np.float32)}


def _block(sd: dict, base: str) -> dict:
    fsmn = np.asarray(sd[f"{base}.self_attn.fsmn_block.weight"], np.float32)
    return {
        "norm1": _ln(sd, f"{base}.norm1"),
        "qkv": _dense(sd, f"{base}.self_attn.linear_q_k_v"),
        "fsmn": {"kernel": np.transpose(fsmn, (2, 1, 0))},  # [D,1,k]->[k,1,D]
        "out": _dense(sd, f"{base}.self_attn.linear_out"),
        "norm2": _ln(sd, f"{base}.norm2"),
        "ffn1": _dense(sd, f"{base}.feed_forward.w_1"),
        "ffn2": _dense(sd, f"{base}.feed_forward.w_2"),
    }


def convert_sensevoice_state_dict(
    sd: dict, cfg: SenseVoiceConfig = SenseVoiceConfig()
) -> dict:
    """torch state dict -> flax param tree for SenseVoiceEncoder."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params: dict = {
        "embed": np.asarray(sd["embed.weight"], np.float32),
        "block0": _block(sd, "encoder.encoders0.0"),
        "final_ln": _ln(sd, "encoder.after_norm"),
        "ctc_head": _dense(sd, "ctc.ctc_lo"),
    }
    for i in range(1, cfg.n_layers):
        params[f"block{i}"] = _block(sd, f"encoder.encoders.{i - 1}")
    for i in range(cfg.tp_blocks):
        params[f"tp_block{i}"] = _block(sd, f"encoder.tp_encoders.{i}")
    params["tp_norm"] = _ln(sd, "encoder.tp_norm")
    return params


def convert_sensevoice_file(
    ckpt_path: str | Path, out_path: str | Path,
    cfg: SenseVoiceConfig = SenseVoiceConfig(),
) -> None:
    """model.pt -> sensevoice.npz."""
    import torch

    from fluidaudio_tpu_torch.utils.checkpoint import save_params

    raw = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    sd = {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in sd.items()}
    params = convert_sensevoice_state_dict(sd, cfg)
    save_params(out_path, {"params": params})
    logger.info("wrote %s", out_path)
