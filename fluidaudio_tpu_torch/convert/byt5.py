"""HF T5/ByT5 checkpoint -> flax params for `models/byt5_g2p.ByT5G2P`.

Input: a torch state dict in the standard `T5ForConditionalGeneration`
layout (`shared.weight`, `encoder.block.N.layer.{0,1}...`,
`decoder.block.N.layer.{0,1,2}...`, `lm_head.weight`) — the layout the
CharsiuG2P releases ship (reference `TTS/G2P/MultilingualG2PModel.swift:9`
consumes the same weights as two CoreML programs). Linear weights are
stored [out, in] in torch; flax Dense wants [in, out].
"""

from __future__ import annotations

import numpy as np

from fluidaudio_tpu_torch.models.byt5_g2p import ByT5Config


class ConversionError(ValueError):
    pass


def _np(t):
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def config_from_hf(cfg_json: dict) -> ByT5Config:
    """Build a ByT5Config from an HF `config.json` payload."""
    return ByT5Config(
        vocab_size=cfg_json["vocab_size"],
        d_model=cfg_json["d_model"],
        d_kv=cfg_json["d_kv"],
        d_ff=cfg_json["d_ff"],
        num_layers=cfg_json["num_layers"],
        num_decoder_layers=cfg_json.get("num_decoder_layers",
                                        cfg_json["num_layers"]),
        num_heads=cfg_json["num_heads"],
        relative_attention_num_buckets=cfg_json.get(
            "relative_attention_num_buckets", 32),
        relative_attention_max_distance=cfg_json.get(
            "relative_attention_max_distance", 128),
        layer_norm_epsilon=cfg_json.get("layer_norm_epsilon", 1e-6),
        tie_word_embeddings=cfg_json.get("tie_word_embeddings", False),
    )


def convert_byt5_state_dict(sd: dict, cfg: ByT5Config) -> dict:
    """-> {"params": {...}} tree matching ByT5G2P.setup naming."""
    sd = {k: v for k, v in sd.items()}

    def take(key):
        if key not in sd:
            raise ConversionError(f"missing checkpoint key {key}")
        return _np(sd.pop(key))

    def dense(key):
        return {"kernel": take(key).T}

    def attn(prefix, has_bias):
        out = {
            "q": dense(f"{prefix}.q.weight"),
            "k": dense(f"{prefix}.k.weight"),
            "v": dense(f"{prefix}.v.weight"),
            "o": dense(f"{prefix}.o.weight"),
        }
        if has_bias:
            out["relative_attention_bias"] = {
                "embedding": take(f"{prefix}.relative_attention_bias.weight")
            }
        return out

    def ffn(prefix):
        return {
            "wi_0": dense(f"{prefix}.wi_0.weight"),
            "wi_1": dense(f"{prefix}.wi_1.weight"),
            "wo": dense(f"{prefix}.wo.weight"),
        }

    def ln(key):
        return {"weight": take(key)}

    p: dict = {"shared": {"embedding": take("shared.weight")}}
    for k in ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight"):
        sd.pop(k, None)  # aliases of shared.weight

    for i in range(cfg.num_layers):
        b = f"encoder.block.{i}"
        p[f"enc{i}_attn_ln"] = ln(f"{b}.layer.0.layer_norm.weight")
        p[f"enc{i}_attn"] = attn(f"{b}.layer.0.SelfAttention", i == 0)
        p[f"enc{i}_ffn_ln"] = ln(f"{b}.layer.1.layer_norm.weight")
        p[f"enc{i}_ffn"] = ffn(f"{b}.layer.1.DenseReluDense")
    p["enc_final_ln"] = ln("encoder.final_layer_norm.weight")

    for i in range(cfg.num_decoder_layers):
        b = f"decoder.block.{i}"
        p[f"dec{i}_self_ln"] = ln(f"{b}.layer.0.layer_norm.weight")
        p[f"dec{i}_self"] = attn(f"{b}.layer.0.SelfAttention", i == 0)
        p[f"dec{i}_cross_ln"] = ln(f"{b}.layer.1.layer_norm.weight")
        p[f"dec{i}_cross"] = attn(f"{b}.layer.1.EncDecAttention", False)
        p[f"dec{i}_ffn_ln"] = ln(f"{b}.layer.2.layer_norm.weight")
        p[f"dec{i}_ffn"] = ffn(f"{b}.layer.2.DenseReluDense")
    p["dec_final_ln"] = ln("decoder.final_layer_norm.weight")

    if not cfg.tie_word_embeddings:
        p["lm_head"] = dense("lm_head.weight")
    else:
        sd.pop("lm_head.weight", None)

    leftovers = [k for k in sd if not k.endswith("position_ids")]
    if leftovers:
        raise ConversionError(f"unmapped checkpoint keys: {leftovers[:8]}")
    return {"params": p}
