"""Kokoro-82M torch checkpoint -> flax param trees for the two programs.

Input: the upstream `kokoro-v1_0.pth` state dict flattened with module
prefixes `bert. / bert_encoder. / predictor. / text_encoder. / decoder.`
(any `module.` wrappers stripped), values as numpy arrays. The reference
consumes the same weights as 7 CoreML stages
(`KokoroAne/Pipeline/KokoroAneSynthesizer.swift:17-160`); here they map onto
`models/kokoro.py` KokoroTextProgram / KokoroAudioProgram.

Conventions:
- torch Linear weight [out,in]  -> flax Dense kernel [in,out] (transpose)
- torch Conv1d weight [out,in,k] -> flax Conv kernel [k,in,out]
- torch ConvTranspose1d weight [in,out,k] -> [k,in,out] (module flips time)
- torch weight_norm (weight_g, weight_v) folded: w = g * v / ||v||_dim0
- torch LSTM weight_ih_l0/_hh_l0 (+_reverse) -> BiLstm fwd/bwd ih/hh Dense
  (gate order i,f,g,o is shared, no reorder)
"""

from __future__ import annotations

import numpy as np

from fluidaudio_tpu_torch.models.kokoro import KokoroConfig


def _t(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _conv(w):
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 1, 0)))


def _fold_wn(sd, prefix):
    """Fold torch weight_norm g/v into a plain weight; pass through when the
    checkpoint was saved with weight norm already removed."""
    if f"{prefix}.weight" in sd:
        return np.asarray(sd[f"{prefix}.weight"])
    g = np.asarray(sd[f"{prefix}.weight_g"])
    v = np.asarray(sd[f"{prefix}.weight_v"])
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def _dense(sd, prefix):
    return {"kernel": _t(sd[f"{prefix}.weight"]), "bias": np.asarray(sd[f"{prefix}.bias"])}


def _conv1d(sd, prefix, bias=True):
    out = {"kernel": _conv(_fold_wn(sd, prefix))}
    if bias:
        out["bias"] = np.asarray(sd[f"{prefix}.bias"])
    return out


def _ln(sd, prefix):
    return {"scale": np.asarray(sd[f"{prefix}.weight"]), "bias": np.asarray(sd[f"{prefix}.bias"])}


def _lstm_dir(sd, prefix, suffix=""):
    return {
        "ih": {"kernel": _t(sd[f"{prefix}.weight_ih_l0{suffix}"]),
               "bias": np.asarray(sd[f"{prefix}.bias_ih_l0{suffix}"])},
        "hh": {"kernel": _t(sd[f"{prefix}.weight_hh_l0{suffix}"]),
               "bias": np.asarray(sd[f"{prefix}.bias_hh_l0{suffix}"])},
    }


def _bilstm(sd, prefix):
    return {
        "fwd": {"cell": _lstm_dir(sd, prefix)},
        "bwd": {"cell": _lstm_dir(sd, prefix, "_reverse")},
    }


def _adain(sd, prefix):
    return {"fc": _dense(sd, f"{prefix}.fc")}


def _adain_resblk(sd, prefix, upsample=False, learned_sc=None):
    out = {
        "norm1": _adain(sd, f"{prefix}.norm1"),
        "norm2": _adain(sd, f"{prefix}.norm2"),
        "conv1": _conv1d(sd, f"{prefix}.conv1"),
        "conv2": _conv1d(sd, f"{prefix}.conv2"),
    }
    if learned_sc is None:
        learned_sc = f"{prefix}.conv1x1.weight_v" in sd or f"{prefix}.conv1x1.weight" in sd
    if learned_sc:
        out["conv1x1"] = _conv1d(sd, f"{prefix}.conv1x1", bias=False)
    if upsample:
        # depthwise ConvTranspose1d weight [C, 1, 3] -> [3, 1, C]
        w = _fold_wn(sd, f"{prefix}.pool")
        out["pool_kernel"] = np.transpose(w, (2, 1, 0))
        out["pool_bias"] = np.asarray(sd[f"{prefix}.pool.bias"])
    return out


def _snake_resblock(sd, prefix, n=3):
    out = {}
    for j in range(n):
        out[f"conv1_{j}"] = _conv1d(sd, f"{prefix}.convs1.{j}")
        out[f"conv2_{j}"] = _conv1d(sd, f"{prefix}.convs2.{j}")
        out[f"adain1_{j}"] = _adain(sd, f"{prefix}.adain1.{j}")
        out[f"adain2_{j}"] = _adain(sd, f"{prefix}.adain2.{j}")
        # torch alpha [1, C, 1] -> [1, 1, C]
        out[f"alpha1_{j}"] = np.transpose(np.asarray(sd[f"{prefix}.alpha1.{j}"]), (0, 2, 1))
        out[f"alpha2_{j}"] = np.transpose(np.asarray(sd[f"{prefix}.alpha2.{j}"]), (0, 2, 1))
    return out


def convert_kokoro_state_dict(
    sd: dict, cfg: KokoroConfig | None = None
) -> dict[str, dict]:
    """-> {"text": text-program params, "audio": audio-program params}."""
    cfg = cfg or KokoroConfig()
    sd = {k.replace("module.", "", 1) if k.startswith("module.") else k: v
          for k, v in sd.items()}

    al = "bert.encoder.albert_layer_groups.0.albert_layers.0"
    albert = {
        "word_emb": {"embedding": np.asarray(sd["bert.embeddings.word_embeddings.weight"])},
        "pos_emb": {"embedding": np.asarray(sd["bert.embeddings.position_embeddings.weight"])},
        "type_emb": {"embedding": np.asarray(sd["bert.embeddings.token_type_embeddings.weight"])},
        "emb_ln": _ln(sd, "bert.embeddings.LayerNorm"),
        "map_in": _dense(sd, "bert.encoder.embedding_hidden_mapping_in"),
        "layer": {
            "q": _dense(sd, f"{al}.attention.query"),
            "k": _dense(sd, f"{al}.attention.key"),
            "v": _dense(sd, f"{al}.attention.value"),
            "o": _dense(sd, f"{al}.attention.dense"),
            "attn_ln": _ln(sd, f"{al}.attention.LayerNorm"),
            "ffn_in": _dense(sd, f"{al}.ffn"),
            "ffn_out": _dense(sd, f"{al}.ffn_output"),
            "out_ln": _ln(sd, f"{al}.full_layer_layer_norm"),
        },
    }

    dur_enc = {}
    for i in range(cfg.n_layer):
        dur_enc[f"lstm_{i}"] = _bilstm(sd, f"predictor.text_encoder.lstms.{2 * i}")
        dur_enc[f"adaln_{i}"] = {
            "fc": _dense(sd, f"predictor.text_encoder.lstms.{2 * i + 1}.fc")
        }

    text_enc = {
        "embed": {"embedding": np.asarray(sd["text_encoder.embedding.weight"])},
        "lstm": _bilstm(sd, "text_encoder.lstm"),
    }
    for i in range(cfg.n_layer):
        text_enc[f"conv_{i}"] = _conv1d(sd, f"text_encoder.cnn.{i}.0")
        text_enc[f"ln_{i}"] = {
            "scale": np.asarray(sd[f"text_encoder.cnn.{i}.1.gamma"]),
            "bias": np.asarray(sd[f"text_encoder.cnn.{i}.1.beta"]),
        }

    text = {
        "albert": albert,
        "bert_encoder": _dense(sd, "bert_encoder"),
        "dur_encoder": dur_enc,
        "pred_lstm": _bilstm(sd, "predictor.lstm"),
        "duration_proj": _dense(sd, "predictor.duration_proj.linear_layer"),
        "text_encoder": text_enc,
    }

    prosody = {"shared": _bilstm(sd, "predictor.shared")}
    for head, tkey in (("f0", "F0"), ("n", "N")):
        for i, up in enumerate((False, True, False)):
            prosody[f"{head}_{i}"] = _adain_resblk(
                sd, f"predictor.{tkey}.{i}", upsample=up
            )
        prosody[f"{head}_proj"] = _conv1d(sd, f"predictor.{tkey}_proj")

    gen = {
        "m_source": {"l_linear": _dense(sd, "decoder.generator.m_source.l_linear")},
        "conv_post": _conv1d(sd, "decoder.generator.conv_post"),
    }
    n_k = len(cfg.resblock_kernels)
    for i in range(len(cfg.upsample_rates)):
        # ConvTranspose1d weight [in, out, k] -> [k, in, out]
        w = _fold_wn(sd, f"decoder.generator.ups.{i}")
        gen[f"up_kernel_{i}"] = np.transpose(w, (2, 0, 1))
        gen[f"up_bias_{i}"] = np.asarray(sd[f"decoder.generator.ups.{i}.bias"])
        gen[f"noise_conv_{i}"] = _conv1d(sd, f"decoder.generator.noise_convs.{i}")
        gen[f"noise_res_{i}"] = _snake_resblock(sd, f"decoder.generator.noise_res.{i}")
        for j in range(n_k):
            gen[f"resblock_{i}_{j}"] = _snake_resblock(
                sd, f"decoder.generator.resblocks.{i * n_k + j}"
            )

    decoder = {
        "f0_conv": _conv1d(sd, "decoder.F0_conv"),
        "n_conv": _conv1d(sd, "decoder.N_conv"),
        "encode": _adain_resblk(sd, "decoder.encode"),
        "asr_res": _conv1d(sd, "decoder.asr_res.0"),
        "generator": gen,
    }
    for i, up in enumerate((False, False, False, True)):
        decoder[f"decode_{i}"] = _adain_resblk(sd, f"decoder.decode.{i}", upsample=up)

    audio = {"prosody": prosody, "decoder": decoder}
    return {"text": {"params": text}, "audio": {"params": audio}}
