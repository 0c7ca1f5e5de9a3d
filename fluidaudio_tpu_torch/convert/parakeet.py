"""NeMo Parakeet (FastConformer-TDT/RNNT) checkpoint -> npz param pytrees.

Offline converter from the upstream checkpoints the reference's CoreML bundles
were produced from (SURVEY §7 "weights converted offline"). Consumes a NeMo
`.nemo` tar (model_weights.ckpt inside) or a raw torch state dict and emits
`encoder.npz` / `predictor.npz` / `joint.npz` in the registry cache layout
that `models/zoo.AsrModels.load` reads.

Layout/convention mapping (torch -> flax):
  Linear    [out, in]            -> kernel [in, out]
  Conv2d    [O, I, kH, kW]       -> kernel [kH, kW, I, O]
  dw Conv2d [C, 1, kH, kW]       -> kernel [kH, kW, 1, C]
  Conv1d k1 [O, I, 1]            -> Dense kernel [I, O] (pointwise as Dense)
  dw Conv1d [C, 1, k]            -> kernel [k, 1, C]
  LSTM      weight_ih_l0 [4H,in] -> ih kernel [in, 4H] (torch gate order
            i,f,g,o matches models/predictor.LstmCell's split)
  BatchNorm (inference)          -> folded scale/bias:
            scale = gamma / sqrt(var + eps); bias = beta - mean * scale
"""

from __future__ import annotations

import io
import tarfile
from pathlib import Path

import numpy as np

from fluidaudio_tpu_torch.models.conformer import ConformerConfig
from fluidaudio_tpu_torch.models.predictor import PredictorConfig
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("convert")

BN_EPS = 1e-5


def _lin(sd, key):
    # np.asarray(None) is array(None, dtype=object) — NOT None — which
    # would defeat downstream `is not None` guards and poison the tree
    bias = sd.get(f"{key}.bias")
    return (np.asarray(sd[f"{key}.weight"]).T,
            None if bias is None else np.asarray(bias))


def _fold_bn(sd, key):
    gamma = np.asarray(sd[f"{key}.weight"])
    beta = np.asarray(sd[f"{key}.bias"])
    mean = np.asarray(sd[f"{key}.running_mean"])
    var = np.asarray(sd[f"{key}.running_var"])
    scale = gamma / np.sqrt(var + BN_EPS)
    return scale, beta - mean * scale


def _ln(sd, key):
    return {"scale": np.asarray(sd[f"{key}.weight"]),
            "bias": np.asarray(sd[f"{key}.bias"])}


def _dense(sd, key):
    k, b = _lin(sd, key)
    out = {"kernel": k}
    if b is not None:
        out["bias"] = b
    return out


def convert_conformer_encoder(
    sd: dict, ccfg: ConformerConfig, prefix: str = "encoder."
) -> dict:
    """NeMo FastConformer encoder keys (`{prefix}pre_encode.*`,
    `{prefix}layers.{i}.*`) -> flax tree for models/conformer.ConformerEncoder.
    Shared by the Parakeet and Sortformer converters (both wrap the same
    NeMo encoder class)."""

    def conv2d(key, depthwise=False):
        w = sd[f"{key}.weight"]  # [O, I, kH, kW]
        if depthwise:
            w = np.transpose(w, (2, 3, 1, 0))  # [kH, kW, 1, C]
        else:
            w = np.transpose(w, (2, 3, 1, 0))
        out = {"kernel": w}
        if f"{key}.bias" in sd:
            out["bias"] = sd[f"{key}.bias"]
        return out

    subsampling = {
        "stem": conv2d(f"{prefix}pre_encode.conv.0"),
        "dw0": conv2d(f"{prefix}pre_encode.conv.2", depthwise=True),
        "pw0": conv2d(f"{prefix}pre_encode.conv.3"),
        "dw1": conv2d(f"{prefix}pre_encode.conv.5", depthwise=True),
        "pw1": conv2d(f"{prefix}pre_encode.conv.6"),
        "proj": _dense(sd, f"{prefix}pre_encode.out"),
    }

    encoder = {"subsampling": subsampling}
    for i in range(ccfg.n_layers):
        base = f"{prefix}layers.{i}"
        bn_scale, bn_bias = _fold_bn(sd, f"{base}.conv.batch_norm")
        # NeMo's depthwise_conv carries a bias (nn.Conv1d default); the flax
        # module is bias-free, so fold it through the BN affine:
        # BN(x + b) = scale*x + (scale*b + folded_bias)
        dw_bias = sd.get(f"{base}.conv.depthwise_conv.bias")
        if dw_bias is not None:
            bn_bias = bn_bias + bn_scale * np.asarray(dw_bias)
        dw = sd[f"{base}.conv.depthwise_conv.weight"]  # [C, 1, k]
        pw1_w = sd[f"{base}.conv.pointwise_conv1.weight"][:, :, 0].T  # [d, 2d]
        pw2_w = sd[f"{base}.conv.pointwise_conv2.weight"][:, :, 0].T
        block = {
            "ffn1_ln": _ln(sd, f"{base}.norm_feed_forward1"),
            "ffn1_fc1": _dense(sd, f"{base}.feed_forward1.linear1"),
            "ffn1_fc2": _dense(sd, f"{base}.feed_forward1.linear2"),
            "mhsa": {
                "ln": _ln(sd, f"{base}.norm_self_att"),
                "q": _dense(sd, f"{base}.self_attn.linear_q"),
                "k": _dense(sd, f"{base}.self_attn.linear_k"),
                "v": _dense(sd, f"{base}.self_attn.linear_v"),
                "out": _dense(sd, f"{base}.self_attn.linear_out"),
                "pos": {"kernel": sd[f"{base}.self_attn.linear_pos.weight"].T},
                "pos_bias_u": sd[f"{base}.self_attn.pos_bias_u"],
                "pos_bias_v": sd[f"{base}.self_attn.pos_bias_v"],
            },
            "conv": {
                "ln": _ln(sd, f"{base}.norm_conv"),
                "pointwise1": {
                    "kernel": pw1_w,
                    **({"bias": sd[f"{base}.conv.pointwise_conv1.bias"]}
                       if f"{base}.conv.pointwise_conv1.bias" in sd else {}),
                },
                "depthwise": {"kernel": np.transpose(dw, (2, 1, 0))},
                "bn_scale": bn_scale,
                "bn_bias": bn_bias,
                "pointwise2": {
                    "kernel": pw2_w,
                    **({"bias": sd[f"{base}.conv.pointwise_conv2.bias"]}
                       if f"{base}.conv.pointwise_conv2.bias" in sd else {}),
                },
            },
            "ffn2_ln": _ln(sd, f"{base}.norm_feed_forward2"),
            "ffn2_fc1": _dense(sd, f"{base}.feed_forward2.linear1"),
            "ffn2_fc2": _dense(sd, f"{base}.feed_forward2.linear2"),
            "final_ln": _ln(sd, f"{base}.norm_out"),
        }
        encoder[f"block{i}"] = block
    return encoder


def convert_parakeet_state_dict(
    sd: dict, ccfg: ConformerConfig, pcfg: PredictorConfig
) -> dict:
    """torch state dict -> {"encoder","predictor","joint"} flax param trees."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    encoder = convert_conformer_encoder(sd, ccfg, prefix="encoder.")

    # ------------------------------------------------------------- predictor
    predictor = {
        "embedding": sd["decoder.prediction.embed.weight"],
    }
    for layer in range(pcfg.n_layers):
        predictor[f"lstm{layer}"] = {
            "ih": {
                "kernel": sd[f"decoder.prediction.dec_rnn.lstm.weight_ih_l{layer}"].T,
                "bias": sd[f"decoder.prediction.dec_rnn.lstm.bias_ih_l{layer}"],
            },
            "hh": {
                "kernel": sd[f"decoder.prediction.dec_rnn.lstm.weight_hh_l{layer}"].T,
                "bias": sd[f"decoder.prediction.dec_rnn.lstm.bias_hh_l{layer}"],
            },
        }

    # ----------------------------------------------------------------- joint
    # NeMo RNNTJoint: enc/pred projections + joint_net Sequential(ReLU, Linear)
    out_key = next(
        (k[: -len(".weight")] for k in sd
         if k.startswith("joint.joint_net") and k.endswith(".weight")),
        None,
    )
    joint = {
        "enc_proj": _dense(sd, "joint.enc"),
        "pred_proj": _dense(sd, "joint.pred"),
        "out": _dense(sd, out_key) if out_key else None,
    }

    return {
        "encoder": {"params": encoder},
        "predictor": {"params": predictor},
        "joint": {"params": joint},
    }


def config_from_nemo_yaml(nemo_path: str | Path) -> dict:
    """Read encoder hyperparameters from a .nemo tar's model_config.yaml.

    Returns the raw `encoder` section (d_model, n_layers, n_heads,
    conv_kernel_size, subsampling_conv_channels, xscaling, ...) so callers
    can build/validate a ConformerConfig against the checkpoint instead of
    trusting a hardcoded preset. `xscaling` in particular is a weights-day
    contract (sqrt(d_model) feature scaling, ConformerConfig.xscale)."""
    import yaml

    with tarfile.open(Path(nemo_path)) as tar:
        member = next(
            (m for m in tar.getmembers() if m.name.endswith("model_config.yaml")),
            None,
        )
        if member is None:
            raise FileNotFoundError(f"no model_config.yaml inside {nemo_path}")
        cfg = yaml.safe_load(tar.extractfile(member).read())
    return cfg.get("encoder", cfg)


def apply_nemo_encoder_yaml(ccfg: ConformerConfig, enc_yaml: dict) -> ConformerConfig:
    """Override the ConformerConfig fields the yaml pins (logs each change)."""
    from dataclasses import replace

    mapping = {
        "d_model": "d_model",
        "n_layers": "n_layers",
        "n_heads": "n_heads",
        "conv_kernel_size": "conv_kernel",
        "subsampling_conv_channels": "subsampling_channels",
        "feat_in": "n_mels",
        "xscaling": "xscale",
    }
    updates = {}
    for src, dst in mapping.items():
        if src in enc_yaml and enc_yaml[src] is not None:
            val = enc_yaml[src]
            if getattr(ccfg, dst) != val:
                logger.info("nemo yaml overrides %s: %s -> %s",
                            dst, getattr(ccfg, dst), val)
                updates[dst] = val
    return replace(ccfg, **updates) if updates else ccfg


def convert_nemo_file(
    nemo_path: str | Path,
    out_dir: str | Path,
    ccfg: ConformerConfig,
    pcfg: PredictorConfig,
) -> None:
    """Read a .nemo tar (or raw .ckpt), convert, write npz trees + vocab."""
    import torch

    nemo_path = Path(nemo_path)
    if nemo_path.suffix == ".nemo":
        try:
            ccfg = apply_nemo_encoder_yaml(ccfg, config_from_nemo_yaml(nemo_path))
        except Exception as exc:  # yaml absent/odd: trust the caller's preset
            logger.warning("could not read model_config.yaml (%s); "
                           "using the preset config as-is", exc)
        with tarfile.open(nemo_path) as tar:
            member = next(
                m for m in tar.getmembers() if m.name.endswith("model_weights.ckpt")
            )
            sd = torch.load(
                io.BytesIO(tar.extractfile(member).read()),
                map_location="cpu", weights_only=True,
            )
    else:
        sd = torch.load(nemo_path, map_location="cpu", weights_only=True)
    sd = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}

    trees = convert_parakeet_state_dict(sd, ccfg, pcfg)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    from fluidaudio_tpu_torch.utils.checkpoint import save_params

    for name, tree in trees.items():
        save_params(out / f"{name}.npz", tree)
        logger.info("wrote %s", out / f"{name}.npz")
