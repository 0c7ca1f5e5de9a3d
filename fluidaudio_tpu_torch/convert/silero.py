"""silero-vad v5 jit checkpoint -> npz param pytree for SileroVadV5.

Offline converter from the upstream silero-vad TorchScript model — the source
of the reference's unified VAD CoreML bundle (`VAD/VadManager.swift`). Key
layout (the jit blob's state dict, `_model.` prefix stripped):

  stft.forward_basis_buffer [258,1,256] -> stft_basis/kernel [256,1,258]
  encoder.{0..3}.reparam_conv.{weight,bias} (Conv1d [O,I,3]) -> enc{i}
  decoder.rnn.{weight,bias}_{ih,hh} (LSTMCell, torch i,f,g,o) -> lstm/{ih,hh}
  decoder.decoder.2.{weight,bias} (Conv1d [1,128,1]) -> head (Dense [128,1])
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fluidaudio_tpu_torch.models.silero_vad import SileroV5Config
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("convert")


def convert_silero_state_dict(
    sd: dict, cfg: SileroV5Config = SileroV5Config()
) -> dict:
    """torch (jit) state dict -> flax param tree for SileroVadV5."""
    sd = {k.removeprefix("_model."): np.asarray(v) for k, v in sd.items()}

    basis = sd["stft.forward_basis_buffer"]  # [258, 1, 256]
    params: dict = {
        "stft_basis": {"kernel": np.transpose(basis, (2, 1, 0)).astype(np.float32)},
    }
    for i in range(len(cfg.encoder_dims)):
        w = np.asarray(sd[f"encoder.{i}.reparam_conv.weight"], np.float32)  # [O,I,3]
        params[f"enc{i}"] = {
            "kernel": np.transpose(w, (2, 1, 0)),
            "bias": np.asarray(sd[f"encoder.{i}.reparam_conv.bias"], np.float32),
        }
    params["lstm"] = {
        "ih": {"kernel": np.asarray(sd["decoder.rnn.weight_ih"], np.float32).T,
               "bias": np.asarray(sd["decoder.rnn.bias_ih"], np.float32)},
        "hh": {"kernel": np.asarray(sd["decoder.rnn.weight_hh"], np.float32).T,
               "bias": np.asarray(sd["decoder.rnn.bias_hh"], np.float32)},
    }
    w = np.asarray(sd["decoder.decoder.2.weight"], np.float32)  # [1, 128, 1]
    params["head"] = {"kernel": w[:, :, 0].T,
                      "bias": np.asarray(sd["decoder.decoder.2.bias"], np.float32)}
    return params


def convert_silero_file(
    ckpt_path: str | Path, out_path: str | Path,
    cfg: SileroV5Config = SileroV5Config(),
) -> None:
    """silero_vad.jit -> vad.npz (loads via torch.jit, falls back to plain)."""
    import torch

    from fluidaudio_tpu_torch.utils.checkpoint import save_params

    try:
        mod = torch.jit.load(ckpt_path, map_location="cpu")
        sd = {k: v.numpy() for k, v in mod.state_dict().items()}
    except RuntimeError:
        raw = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        sd = {k: v.numpy() for k, v in raw.items()}
    params = convert_silero_state_dict(sd, cfg)
    save_params(out_path, {"params": params})
    logger.info("wrote %s", out_path)
