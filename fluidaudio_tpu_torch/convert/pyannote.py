"""pyannote/segmentation-3.0 checkpoint -> npz param pytree for PyanNet.

Offline converter from the upstream pyannote.audio torch checkpoint — the
source of the reference's segmentation CoreML bundle
(`Diarizer/Segmentation/SegmentationProcessor.swift`). Key layout
(pyannote.audio PyanNet + SincNet blocks):

  sincnet.wav_norm1d              -> wav_norm (InstanceNorm1d affine)
  sincnet.conv1d.0.filterbank.*   -> sinc/kernel (filters MATERIALIZED here
                                     from low_hz_/band_hz_ — see below)
  sincnet.norm1d.{0,1,2}          -> norm{0,1,2}
  sincnet.conv1d.{1,2}            -> conv{1,2}
  lstm.weight_*_l{k}[_reverse]    -> lstm{k}_{fwd,bwd}/cell/{ih,hh}
  linear.{0,1}                    -> linear{0,1}
  classifier                      -> classifier

Sinc materialization (asteroid_filterbanks.ParamSincFB == SincNet-fast math):
  low  = min_low_hz + |low_hz_|
  high = clip(low + min_band_hz + |band_hz_|, min_low_hz, sr/2)
  h[n] = (sin(2*pi*high*n) - sin(2*pi*low*n)) / (pi*n) windowed (Hamming half),
  center 2*band, normalized by 2*band. Inference-time the filterbank is a
  fixed conv kernel, so conversion bakes it in.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from fluidaudio_tpu_torch.models.pyannote_seg import PyanNetConfig
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("convert")

SAMPLE_RATE = 16_000
MIN_LOW_HZ = 50.0
MIN_BAND_HZ = 50.0


def materialize_sinc_filters(
    low_hz: np.ndarray, band_hz: np.ndarray, kernel_size: int,
    sample_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """(low_hz_ [F,1], band_hz_ [F,1]) -> filters [F, kernel_size]."""
    low_hz = np.asarray(low_hz, np.float64).reshape(-1)
    band_hz = np.asarray(band_hz, np.float64).reshape(-1)
    low = MIN_LOW_HZ + np.abs(low_hz)
    high = np.clip(low + MIN_BAND_HZ + np.abs(band_hz), MIN_LOW_HZ,
                   sample_rate / 2)
    band = (high - low)[:, None]

    half = (kernel_size - 1) // 2
    # Hamming window over the left half (SincNet-fast computes half then
    # mirrors; window defined over the full kernel length)
    n_lin = np.linspace(0, kernel_size / 2 - 1, half)
    window = 0.54 - 0.46 * np.cos(2 * np.pi * n_lin / kernel_size)
    # negative time axis (scaled by 2*pi/sr)
    n = 2 * np.pi * np.arange(-half, 0, dtype=np.float64) / sample_rate

    f_low = low[:, None] * n
    f_high = high[:, None] * n
    left = (np.sin(f_high) - np.sin(f_low)) / (n / 2) * window[None, :]
    center = 2 * band
    right = left[:, ::-1]
    filters = np.concatenate([left, center, right], axis=1) / (2 * band)
    return filters.astype(np.float32)  # [F, kernel]


def _in(sd: dict, key: str) -> dict:
    return {"scale": np.asarray(sd[f"{key}.weight"], np.float32),
            "bias": np.asarray(sd[f"{key}.bias"], np.float32)}


def _dense(sd: dict, key: str) -> dict:
    return {"kernel": np.asarray(sd[f"{key}.weight"], np.float32).T,
            "bias": np.asarray(sd[f"{key}.bias"], np.float32)}


def _lstm_dir(sd: dict, layer: int, reverse: bool) -> dict:
    sfx = "_reverse" if reverse else ""
    return {"cell": {
        "ih": {"kernel": np.asarray(sd[f"lstm.weight_ih_l{layer}{sfx}"], np.float32).T,
               "bias": np.asarray(sd[f"lstm.bias_ih_l{layer}{sfx}"], np.float32)},
        "hh": {"kernel": np.asarray(sd[f"lstm.weight_hh_l{layer}{sfx}"], np.float32).T,
               "bias": np.asarray(sd[f"lstm.bias_hh_l{layer}{sfx}"], np.float32)},
    }}


def convert_pyannote_state_dict(
    sd: dict, cfg: PyanNetConfig = PyanNetConfig()
) -> dict:
    """torch state dict -> flax param tree for PyanNet."""
    sd = {k: np.asarray(v) for k, v in sd.items()}

    filters = materialize_sinc_filters(
        sd["sincnet.conv1d.0.filterbank.low_hz_"],
        sd["sincnet.conv1d.0.filterbank.band_hz_"],
        cfg.sinc_kernel,
    )  # [F, k] -> flax conv kernel [k, 1, F]
    params: dict = {
        "wav_norm": _in(sd, "sincnet.wav_norm1d"),
        "sinc": {"kernel": filters.T[:, None, :]},
        "norm0": _in(sd, "sincnet.norm1d.0"),
    }
    for i in (1, 2):
        w = np.asarray(sd[f"sincnet.conv1d.{i}.weight"], np.float32)  # [O, I, k]
        params[f"conv{i}"] = {
            "kernel": np.transpose(w, (2, 1, 0)),
            "bias": np.asarray(sd[f"sincnet.conv1d.{i}.bias"], np.float32),
        }
        params[f"norm{i}"] = _in(sd, f"sincnet.norm1d.{i}")

    for l in range(cfg.lstm_layers):
        params[f"lstm{l}_fwd"] = _lstm_dir(sd, l, reverse=False)
        params[f"lstm{l}_bwd"] = _lstm_dir(sd, l, reverse=True)

    for i in range(len(cfg.linear_dims)):
        params[f"linear{i}"] = _dense(sd, f"linear.{i}")
    params["classifier"] = _dense(sd, "classifier")
    return params


def convert_pyannote_file(
    ckpt_path: str | Path, out_path: str | Path,
    cfg: PyanNetConfig = PyanNetConfig(),
) -> None:
    """pytorch_model.bin / .ckpt -> segmentation.npz."""
    import torch

    from fluidaudio_tpu_torch.utils.checkpoint import save_params

    raw = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    sd = {k.removeprefix("model."): (v.numpy() if hasattr(v, "numpy") else v)
          for k, v in sd.items()}
    params = convert_pyannote_state_dict(sd, cfg)
    save_params(out_path, {"params": params})
    logger.info("wrote %s", out_path)
