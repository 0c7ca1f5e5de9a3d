"""HF BART checkpoint -> flax params for `models/bart_g2p.BartG2P`.

Input: a torch state dict in `BartForConditionalGeneration` layout
(`model.shared.weight`, `model.encoder.layers.N...`, `final_logits_bias`)
— the layout of the small G2P BART the reference consumes as two CoreML
programs (`TTS/G2P/G2PModel.swift:6`).
"""

from __future__ import annotations

import numpy as np

from fluidaudio_tpu_torch.models.bart_g2p import BartConfig


class ConversionError(ValueError):
    pass


def _np(t):
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def config_from_hf(cfg_json: dict) -> BartConfig:
    return BartConfig(
        vocab_size=cfg_json["vocab_size"],
        d_model=cfg_json["d_model"],
        encoder_layers=cfg_json["encoder_layers"],
        decoder_layers=cfg_json["decoder_layers"],
        encoder_attention_heads=cfg_json["encoder_attention_heads"],
        decoder_attention_heads=cfg_json["decoder_attention_heads"],
        encoder_ffn_dim=cfg_json["encoder_ffn_dim"],
        decoder_ffn_dim=cfg_json["decoder_ffn_dim"],
        max_position_embeddings=cfg_json["max_position_embeddings"],
        scale_embedding=cfg_json.get("scale_embedding", False),
        pad_token_id=cfg_json.get("pad_token_id", 1),
        bos_token_id=cfg_json.get("bos_token_id", 0),
        eos_token_id=cfg_json.get("eos_token_id", 2),
        decoder_start_token_id=cfg_json.get("decoder_start_token_id", 2),
    )


def convert_bart_state_dict(sd: dict, cfg: BartConfig) -> dict:
    sd = dict(sd)

    def take(key):
        if key not in sd:
            raise ConversionError(f"missing checkpoint key {key}")
        return _np(sd.pop(key))

    def dense(prefix):
        return {"kernel": take(f"{prefix}.weight").T, "bias": take(f"{prefix}.bias")}

    def attn(prefix):
        return {
            "q_proj": dense(f"{prefix}.q_proj"),
            "k_proj": dense(f"{prefix}.k_proj"),
            "v_proj": dense(f"{prefix}.v_proj"),
            "out_proj": dense(f"{prefix}.out_proj"),
        }

    def ln(prefix):
        return {"scale": take(f"{prefix}.weight"), "bias": take(f"{prefix}.bias")}

    p: dict = {
        "shared": {"embedding": take("model.shared.weight")},
        "enc_pos": {"embedding": take("model.encoder.embed_positions.weight")},
        "dec_pos": {"embedding": take("model.decoder.embed_positions.weight")},
        "enc_emb_ln": ln("model.encoder.layernorm_embedding"),
        "dec_emb_ln": ln("model.decoder.layernorm_embedding"),
        "final_logits_bias": take("final_logits_bias").reshape(-1),
    }
    for k in ("model.encoder.embed_tokens.weight",
              "model.decoder.embed_tokens.weight", "lm_head.weight"):
        sd.pop(k, None)  # aliases of model.shared.weight

    for i in range(cfg.encoder_layers):
        b = f"model.encoder.layers.{i}"
        p[f"enc{i}_attn"] = attn(f"{b}.self_attn")
        p[f"enc{i}_attn_ln"] = ln(f"{b}.self_attn_layer_norm")
        p[f"enc{i}_fc1"] = dense(f"{b}.fc1")
        p[f"enc{i}_fc2"] = dense(f"{b}.fc2")
        p[f"enc{i}_final_ln"] = ln(f"{b}.final_layer_norm")

    for i in range(cfg.decoder_layers):
        b = f"model.decoder.layers.{i}"
        p[f"dec{i}_self"] = attn(f"{b}.self_attn")
        p[f"dec{i}_self_ln"] = ln(f"{b}.self_attn_layer_norm")
        p[f"dec{i}_cross"] = attn(f"{b}.encoder_attn")
        p[f"dec{i}_cross_ln"] = ln(f"{b}.encoder_attn_layer_norm")
        p[f"dec{i}_fc1"] = dense(f"{b}.fc1")
        p[f"dec{i}_fc2"] = dense(f"{b}.fc2")
        p[f"dec{i}_final_ln"] = ln(f"{b}.final_layer_norm")

    leftovers = [k for k in sd if not k.endswith("position_ids")]
    if leftovers:
        raise ConversionError(f"unmapped checkpoint keys: {leftovers[:8]}")
    return {"params": p}
