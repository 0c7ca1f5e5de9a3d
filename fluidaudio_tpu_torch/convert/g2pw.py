"""HF BERT (g2pW) checkpoint -> flax params for `models/bert_g2pw.BertG2pw`.

Input: a torch state dict in `BertModel` layout (`embeddings.*`,
`encoder.layer.N.attention...`) plus a `classifier.{weight,bias}` head —
the layout of the upstream g2pW release the reference converts to CoreML
(`MandarinG2pwModel.swift:31`: kokoro-82m-coreml/ANE-zh/g2pw). Keys may be
prefixed `bert.`.
"""

from __future__ import annotations

import numpy as np

from fluidaudio_tpu_torch.models.bert_g2pw import BertG2pwConfig


class ConversionError(ValueError):
    pass


def _np(t):
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def config_from_hf(cfg_json: dict, num_labels: int | None = None) -> BertG2pwConfig:
    return BertG2pwConfig(
        vocab_size=cfg_json["vocab_size"],
        hidden_size=cfg_json["hidden_size"],
        num_hidden_layers=cfg_json["num_hidden_layers"],
        num_attention_heads=cfg_json["num_attention_heads"],
        intermediate_size=cfg_json["intermediate_size"],
        max_position_embeddings=cfg_json["max_position_embeddings"],
        type_vocab_size=cfg_json.get("type_vocab_size", 2),
        layer_norm_eps=cfg_json.get("layer_norm_eps", 1e-12),
        num_labels=num_labels or cfg_json.get("num_labels", 700),
    )


def convert_g2pw_state_dict(sd: dict, cfg: BertG2pwConfig) -> dict:
    sd = {k.removeprefix("bert."): v for k, v in sd.items()}

    def take(key):
        if key not in sd:
            raise ConversionError(f"missing checkpoint key {key}")
        return _np(sd.pop(key))

    def dense(prefix):
        return {"kernel": take(f"{prefix}.weight").T, "bias": take(f"{prefix}.bias")}

    def ln(prefix):
        return {"scale": take(f"{prefix}.weight"), "bias": take(f"{prefix}.bias")}

    p: dict = {
        "word_emb": {"embedding": take("embeddings.word_embeddings.weight")},
        "pos_emb": {"embedding": take("embeddings.position_embeddings.weight")},
        "type_emb": {"embedding": take("embeddings.token_type_embeddings.weight")},
        "emb_ln": ln("embeddings.LayerNorm"),
    }
    for i in range(cfg.num_hidden_layers):
        b = f"encoder.layer.{i}"
        p[f"layer{i}_attn"] = {
            "query": dense(f"{b}.attention.self.query"),
            "key": dense(f"{b}.attention.self.key"),
            "value": dense(f"{b}.attention.self.value"),
            "out": dense(f"{b}.attention.output.dense"),
        }
        p[f"layer{i}_attn_ln"] = ln(f"{b}.attention.output.LayerNorm")
        p[f"layer{i}_ffn_in"] = dense(f"{b}.intermediate.dense")
        p[f"layer{i}_ffn_out"] = dense(f"{b}.output.dense")
        p[f"layer{i}_ffn_ln"] = ln(f"{b}.output.LayerNorm")

    p["classifier"] = dense("classifier")
    # pooler / cls heads are unused by the target-gather classifier
    for k in list(sd):
        if k.startswith(("pooler.", "cls.")) or k.endswith("position_ids"):
            sd.pop(k)
    if sd:
        raise ConversionError(f"unmapped checkpoint keys: {sorted(sd)[:8]}")
    return {"params": p}
