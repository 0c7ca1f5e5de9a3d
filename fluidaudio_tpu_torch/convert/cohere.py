"""Cohere Transcribe torch checkpoint -> flax params.

The reference consumes two CoreML graphs converted from the upstream
`cohere-pytorch` release (`Cohere/CoherePipeline.swift:377-440`,
`CohereAsrConfig.swift:25-60`): a Conformer encoder (hidden 1280, 48 layers)
and a cache-external transformer decoder (hidden 1024, 8 heads x 128,
8 layers, KV maxSeqLen 108). Here:

  - encoder: NeMo-style Conformer key names (`encoder.layers.{i}...`) reuse
    `convert/parakeet.convert_conformer_encoder` — the shared trunk.
  - decoder: transformer names `decoder.layers.{i}.{self_attn,encoder_attn}.
    {q,k,v,out}_proj`, `.self_attn_layer_norm/.encoder_attn_layer_norm/
    .final_layer_norm`, `.fc1/.fc2`, plus `decoder.embed_tokens.weight`,
    `decoder.embed_positions.weight`, `decoder.layer_norm` (tied lm head).
    One rename pass may be needed against a given upstream release.
"""

from __future__ import annotations

import numpy as np

from fluidaudio_tpu_torch.models.cohere_asr import CohereConfig
from fluidaudio_tpu_torch.models.conformer import ConformerConfig


def _t(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _dense(sd, key):
    out = {"kernel": _t(sd[f"{key}.weight"])}
    if f"{key}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{key}.bias"])
    return out


def _ln(sd, key):
    return {"scale": np.asarray(sd[f"{key}.weight"]),
            "bias": np.asarray(sd[f"{key}.bias"])}


def cohere_conformer_config(cfg: CohereConfig) -> ConformerConfig:
    return ConformerConfig(
        n_mels=cfg.n_mels,
        d_model=cfg.enc_hidden,
        n_layers=cfg.n_encoder_layers,
        n_heads=cfg.n_enc_heads,
        subsampling_channels=max(32, cfg.enc_hidden // 8),
        dtype=cfg.dtype,
    )


def convert_cohere_encoder_state_dict(sd: dict, cfg: CohereConfig) -> dict:
    """NeMo-style conformer keys -> CohereEncoder params (nested under the
    shared-trunk module name)."""
    from fluidaudio_tpu_torch.convert.parakeet import convert_conformer_encoder

    enc = convert_cohere_encoder_raw(sd, cfg, convert_conformer_encoder)
    return {"params": {"conformer": enc}}


def convert_cohere_encoder_raw(sd, cfg, convert_fn):
    return convert_fn(sd, cohere_conformer_config(cfg))


def convert_cohere_decoder_state_dict(sd: dict, cfg: CohereConfig) -> dict:
    p: dict = {
        "embed": {"embedding": np.asarray(sd["decoder.embed_tokens.weight"])},
        "pos_embed": np.asarray(sd["decoder.embed_positions.weight"])[
            : cfg.max_decode_tokens
        ],
        "final_ln": _ln(sd, "decoder.layer_norm"),
    }
    for i in range(cfg.n_decoder_layers):
        b = f"decoder.layers.{i}"
        p[f"sln{i}"] = _ln(sd, f"{b}.self_attn_layer_norm")
        p[f"q{i}"] = _dense(sd, f"{b}.self_attn.q_proj")
        p[f"k{i}"] = _dense(sd, f"{b}.self_attn.k_proj")
        p[f"v{i}"] = _dense(sd, f"{b}.self_attn.v_proj")
        p[f"so{i}"] = _dense(sd, f"{b}.self_attn.out_proj")
        p[f"cln{i}"] = _ln(sd, f"{b}.encoder_attn_layer_norm")
        p[f"cq{i}"] = _dense(sd, f"{b}.encoder_attn.q_proj")
        p[f"ck{i}"] = _dense(sd, f"{b}.encoder_attn.k_proj")
        p[f"cv{i}"] = _dense(sd, f"{b}.encoder_attn.v_proj")
        p[f"co{i}"] = _dense(sd, f"{b}.encoder_attn.out_proj")
        p[f"fln{i}"] = _ln(sd, f"{b}.final_layer_norm")
        p[f"ff1_{i}"] = _dense(sd, f"{b}.fc1")
        p[f"ff2_{i}"] = _dense(sd, f"{b}.fc2")
    return {"params": p}
