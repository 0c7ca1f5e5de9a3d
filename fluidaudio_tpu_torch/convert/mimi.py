"""Mimi codec torch checkpoint -> flax params for MimiDecoder/MimiEncoder.

Targets the Moshi-style state-dict layout (kyutai mimi / pocket-tts packs;
the reference consumes the same weights as the opaque `mimi_decoder`
CoreML graph, `PocketTtsSynthesizer+Mimi.swift`):

  decoder.model.{i}...            SEANet decoder stack (ELU entries skip
                                  indices: 0=conv_in, per ratio stage
                                  [1+3s]=ELU, [2+3s]=convtr,
                                  [3+3s]=resblock(block.1/block.3),
                                  then [..]=ELU, [last]=conv_out)
  encoder.model.{i}...            mirrored encoder stack
  upsample / downsample           x2 frame-rate resampling depthwise convs
  decoder_transformer.transformer.layers.{i}. / encoder_transformer...
      self_attn.in_proj_weight, self_attn.out_proj.weight, norm1/2,
      linear1/linear2, layer_scale_1.scale/layer_scale_2.scale
  quantizer.output_proj.weight    latent -> dim (decoder input proj)
  quantizer.input_proj.weight     dim -> latent (encoder output proj)

Conv wrappers (StreamableConv1d -> NormConv1d -> raw) produce nested
`.conv.conv.weight` / `.convtr.convtr.weight` key chains; `_find` accepts
any depth. torch Conv1d [out,in,k] -> flax [k,in,out]; ConvTranspose1d
[in,out,k] -> [k,in,out] (modules flip time).
"""

from __future__ import annotations

import numpy as np

from fluidaudio_tpu_torch.models.mimi import MimiConfig


def _find(sd, base, leaf="weight"):
    for key in (
        f"{base}.{leaf}",
        f"{base}.conv.{leaf}",
        f"{base}.conv.conv.{leaf}",
        f"{base}.convtr.{leaf}",
        f"{base}.convtr.convtr.{leaf}",
    ):
        if key in sd:
            return np.asarray(sd[key])
    raise KeyError(f"{base}.{leaf} (tried conv/convtr nestings)")


def _conv(sd, base):
    w = _find(sd, base)
    out = {"kernel": np.ascontiguousarray(np.transpose(w, (2, 1, 0)))}
    try:
        out["bias"] = _find(sd, base, "bias")
    except KeyError:
        out["bias"] = np.zeros(w.shape[0], np.float32)
    return out


def _convtr(sd, base, groups=1):
    w = _find(sd, base)  # [in, out/groups, k]
    # flax layout [k, in/groups, out]: depthwise (groups=in) keeps the
    # per-channel kernels on the last axis
    perm = (2, 1, 0) if groups > 1 else (2, 0, 1)
    out = {"kernel": np.ascontiguousarray(np.transpose(w, perm))}
    try:
        b = _find(sd, base, "bias")
    except KeyError:
        b = np.zeros(w.shape[0] if groups > 1 else w.shape[1], np.float32)
    out["bias"] = b
    return out


def _t(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _trans_layer(sd, base):
    return {
        "norm1": {"scale": np.asarray(sd[f"{base}.norm1.weight"]),
                  "bias": np.asarray(sd[f"{base}.norm1.bias"])},
        "norm2": {"scale": np.asarray(sd[f"{base}.norm2.weight"]),
                  "bias": np.asarray(sd[f"{base}.norm2.bias"])},
        "in_proj": {"kernel": _t(sd[f"{base}.self_attn.in_proj_weight"])},
        "out_proj": {"kernel": _t(sd[f"{base}.self_attn.out_proj.weight"])},
        "mlp_in": {"kernel": _t(sd[f"{base}.linear1.weight"])},
        "mlp_out": {"kernel": _t(sd[f"{base}.linear2.weight"])},
        "layer_scale_1": np.asarray(sd[f"{base}.layer_scale_1.scale"]),
        "layer_scale_2": np.asarray(sd[f"{base}.layer_scale_2.scale"]),
    }


def convert_mimi_decoder_state_dict(sd: dict, cfg: MimiConfig | None = None) -> dict:
    cfg = cfg or MimiConfig()
    p: dict = {}

    # latent input proj: quantizer output proj (conv1x1 [dim, latent, 1])
    for key in ("quantizer.output_proj", "input_proj"):
        try:
            w = _find(sd, key)
            p["input_proj"] = {"kernel": _t(w[..., 0] if w.ndim == 3 else w)}
            break
        except KeyError:
            continue
    if "input_proj" not in p:
        raise KeyError("quantizer.output_proj / input_proj")

    p["upsample"] = _convtr(sd, "upsample", groups=cfg.dim)

    for i in range(cfg.trans_layers):
        p[f"tr_{i}"] = _trans_layer(
            sd, f"decoder_transformer.transformer.layers.{i}"
        )

    p["conv_in"] = _conv(sd, "decoder.model.0")
    for s in range(len(cfg.ratios)):
        base = 1 + 3 * s
        p[f"up_{s}"] = _convtr(sd, f"decoder.model.{base + 1}")
        p[f"res_{s}_a"] = _conv(sd, f"decoder.model.{base + 2}.block.1")
        p[f"res_{s}_b"] = _conv(sd, f"decoder.model.{base + 2}.block.3")
    last = 1 + 3 * len(cfg.ratios) + 1
    p["conv_out"] = _conv(sd, f"decoder.model.{last}")
    return {"params": p}


def convert_mimi_encoder_state_dict(sd: dict, cfg: MimiConfig | None = None) -> dict:
    cfg = cfg or MimiConfig()
    p: dict = {}
    p["conv_in"] = _conv(sd, "encoder.model.0")
    for s in range(len(cfg.ratios)):
        base = 1 + 3 * s
        p[f"res_{s}_a"] = _conv(sd, f"encoder.model.{base}.block.1")
        p[f"res_{s}_b"] = _conv(sd, f"encoder.model.{base}.block.3")
        p[f"down_{s}"] = _conv(sd, f"encoder.model.{base + 2}")
    last = 1 + 3 * len(cfg.ratios) + 1
    p["conv_out"] = _conv(sd, f"encoder.model.{last}")
    dw = _find(sd, "downsample")
    p["downsample"] = {
        "kernel": np.ascontiguousarray(np.transpose(dw, (2, 1, 0))),
        "bias": np.zeros(dw.shape[0], np.float32),
    }
    try:
        p["downsample"]["bias"] = _find(sd, "downsample", "bias")
    except KeyError:
        pass
    for i in range(cfg.trans_layers):
        t = _trans_layer(sd, f"encoder_transformer.transformer.layers.{i}")
        p[f"tr_{i}_norm1"] = t["norm1"]
        p[f"tr_{i}_norm2"] = t["norm2"]
        p[f"tr_{i}_in_proj"] = t["in_proj"]
        p[f"tr_{i}_out_proj"] = t["out_proj"]
        p[f"tr_{i}_mlp_in"] = t["mlp_in"]
        p[f"tr_{i}_mlp_out"] = t["mlp_out"]
        p[f"tr_{i}_ls1"] = t["layer_scale_1"]
        p[f"tr_{i}_ls2"] = t["layer_scale_2"]
    w = _find(sd, "quantizer.input_proj")
    p["output_proj"] = {"kernel": _t(w[..., 0] if w.ndim == 3 else w)}
    return {"params": p}
