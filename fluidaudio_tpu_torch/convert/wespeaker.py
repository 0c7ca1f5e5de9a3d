"""WeSpeaker ResNet34 checkpoint -> npz param pytree for WeSpeakerEmbedder.

Offline converter from the upstream wespeaker-voxceleb-resnet34-LM torch
checkpoint — the same source the reference's embedding CoreML bundle was
produced from (`Diarizer/Extraction/EmbeddingExtractor.swift`). Key layout
(wespeaker/models/resnet.py):

  conv1 / bn1                     -> stem / stem_bn
  layer{1..4}.{b}.conv1/bn1/...   -> s{0..3}b{b}/conv1/bn1/...
  layer{s}.{b}.shortcut.0 / .1    -> s{s}b{b}/short / short_bn
  seg_1                           -> embed

Conventions: Conv2d [O, I, kH, kW] -> flax [kH, kW, I, O]; BatchNorm folds to
inference affine (scale = gamma/sqrt(var+eps), bias = beta - mean*scale);
Linear [out, in] -> kernel [in, out].
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fluidaudio_tpu_torch.models.wespeaker import WeSpeakerConfig
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("convert")

BN_EPS = 1e-5


def _conv(sd: dict, key: str) -> dict:
    w = np.asarray(sd[f"{key}.weight"])  # [O, I, kH, kW]
    return {"kernel": np.transpose(w, (2, 3, 1, 0)).astype(np.float32)}


def _bn(sd: dict, key: str) -> dict:
    gamma = np.asarray(sd[f"{key}.weight"], np.float64)
    beta = np.asarray(sd[f"{key}.bias"], np.float64)
    mean = np.asarray(sd[f"{key}.running_mean"], np.float64)
    var = np.asarray(sd[f"{key}.running_var"], np.float64)
    scale = gamma / np.sqrt(var + BN_EPS)
    return {"bn_scale": scale.astype(np.float32),
            "bn_bias": (beta - mean * scale).astype(np.float32)}


def convert_wespeaker_state_dict(
    sd: dict, cfg: WeSpeakerConfig = WeSpeakerConfig(), prefix: str = ""
) -> dict:
    """torch state dict -> flax param tree for WeSpeakerEmbedder."""
    sd = {k[len(prefix):] if prefix and k.startswith(prefix) else k: np.asarray(v)
          for k, v in sd.items()}
    # some exports name the residual projection `downsample` instead
    sd = {k.replace(".downsample.", ".shortcut."): v for k, v in sd.items()}

    params: dict = {
        "stem": _conv(sd, "conv1"),
        "stem_bn": _bn(sd, "bn1"),
    }
    for si, depth in enumerate(cfg.blocks_per_stage):
        for bi in range(depth):
            t = f"layer{si + 1}.{bi}"
            block = {
                "conv1": _conv(sd, f"{t}.conv1"),
                "bn1": _bn(sd, f"{t}.bn1"),
                "conv2": _conv(sd, f"{t}.conv2"),
                "bn2": _bn(sd, f"{t}.bn2"),
            }
            if f"{t}.shortcut.0.weight" in sd:
                block["short"] = _conv(sd, f"{t}.shortcut.0")
                block["short_bn"] = _bn(sd, f"{t}.shortcut.1")
            params[f"s{si}b{bi}"] = block

    # torch TSTP flattens the trunk [B, C, F, T] as index c*F+f; our
    # [S, T, F, C] reshape flattens as f*C+c — permute each stats half
    # (mean, std) of seg_1's input dim from (c, f) to (f, c) ordering.
    w = np.asarray(sd["seg_1.weight"])  # [emb, 2*C*F]
    C, F = cfg.channels[-1], cfg.n_mels // 8
    halves = []
    for h in np.split(w, 2, axis=1):  # mean half, std half
        halves.append(h.reshape(-1, C, F).transpose(0, 2, 1).reshape(w.shape[0], -1))
    w = np.concatenate(halves, axis=1)
    emb = {"kernel": w.T.astype(np.float32)}
    if "seg_1.bias" in sd:
        emb["bias"] = np.asarray(sd["seg_1.bias"], np.float32)
    params["embed"] = emb
    return params


def convert_wespeaker_file(
    ckpt_path: str | Path, out_path: str | Path,
    cfg: WeSpeakerConfig = WeSpeakerConfig(),
) -> None:
    """torch .pt checkpoint -> embedder.npz (flat slash-joined keys)."""
    import torch

    from fluidaudio_tpu_torch.utils.checkpoint import save_params

    raw = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    sd = {k: v.numpy() for k, v in sd.items()}
    prefix = "speaker_extractor." if any(
        k.startswith("speaker_extractor.") for k in sd) else ""
    params = convert_wespeaker_state_dict(sd, cfg, prefix=prefix)
    save_params(out_path, {"params": params})
    logger.info("wrote %s", out_path)
