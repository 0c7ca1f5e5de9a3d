"""StyleTTS2 LibriTTS torch checkpoint -> flax param trees for the 4 programs.

Input: the upstream yl4579/StyleTTS2 second-stage checkpoint
(`epochs_2nd_00020.pth`): a dict whose `net` entry maps module names
(`bert`, `bert_encoder`, `predictor`, `decoder`, `text_encoder`,
`style_encoder`, `predictor_encoder`, `diffusion`, plus training-only
`text_aligner`/`pitch_extractor`/`mpd`/`msd`/`wd`) to state dicts (any
DataParallel `module.` wrappers stripped). The reference consumes the same
weights as 8 fused CoreML stages
(`StyleTTS2/Pipeline/Synthesize/StyleTTS2Synthesizer.swift:33-133`); here
they map onto `models/styletts2.py`'s four jitted programs.

Conventions shared with convert/kokoro.py (the Kokoro-82M graph is a fork of
this one): torch Linear/Conv transposes, weight_norm g*v/||v|| folding,
LSTM gate-order-preserving splits. New here:
  - spectral_norm folding for the 2D style encoders: w = w_orig / sigma with
    sigma = u . (W_mat v) from the stored power-iteration vectors.
  - generator config derivation: upsample rates/kernels and resblock kernel
    sizes are re-derived from checkpoint tensor shapes, so the model config
    always matches the checkpoint's factorization.
  - the style-diffusion denoiser: the upstream `StyleTransformer1d` tree is
    mapped where layer names line up with `models/styletts2.StyleDenoiser`;
    unmapped keys are reported (partial conversion keeps the seeded denoiser
    and logs, `strict=True` raises).
"""

from __future__ import annotations

import numpy as np

from fluidaudio_tpu_torch.convert.kokoro import (
    _adain_resblk,
    _bilstm,
    _conv,
    _conv1d,
    _dense,
    _fold_wn,
    _ln,
    _snake_resblock,
    _t,
)
from fluidaudio_tpu_torch.models.styletts2 import StyleTts2Config
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("convert.styletts2")


class ConversionError(ValueError):
    pass


def flatten_net(ckpt: dict) -> dict:
    """Accept {'net': {module: sd}} or an already-flat {'module.key': w}."""
    if "net" in ckpt and isinstance(ckpt["net"], dict):
        flat = {}
        for mod, sd in ckpt["net"].items():
            if not isinstance(sd, dict):
                continue
            for k, v in sd.items():
                k = k[7:] if k.startswith("module.") else k
                flat[f"{mod}.{k}"] = v
        return flat
    return {
        (k[7:] if k.startswith("module.") else k): v for k, v in ckpt.items()
    }


def _fold_sn(sd, prefix):
    """Fold torch spectral_norm: weight = weight_orig / (u . W v)."""
    if f"{prefix}.weight" in sd:
        return np.asarray(sd[f"{prefix}.weight"])
    w = np.asarray(sd[f"{prefix}.weight_orig"], np.float64)
    u = np.asarray(sd[f"{prefix}.weight_u"], np.float64)
    v = np.asarray(sd[f"{prefix}.weight_v"], np.float64)
    sigma = float(u @ (w.reshape(w.shape[0], -1) @ v))
    return (w / max(sigma, 1e-12)).astype(np.float32)


def _conv2d_sn(sd, prefix, bias=True):
    # torch Conv2d [out, in, kh, kw] -> flax [kh, kw, in, out]
    w = np.transpose(_fold_sn(sd, prefix), (2, 3, 1, 0))
    out = {"kernel": np.ascontiguousarray(w)}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{prefix}.bias"])
    return out


def config_from_state_dict(sd: dict, base: StyleTts2Config | None = None) -> StyleTts2Config:
    """Derive generator factorization + widths from checkpoint shapes."""
    from dataclasses import replace

    cfg = base or StyleTts2Config()
    rates, kernels = [], []
    i = 0
    while f"decoder.generator.ups.{i}.weight_v" in sd or f"decoder.generator.ups.{i}.weight" in sd:
        w = _fold_wn(sd, f"decoder.generator.ups.{i}")  # [in, out, k]
        k = w.shape[2]
        kernels.append(k)
        rates.append(k // 2)  # upstream convention kernel = 2 * stride
        i += 1
    n_res = 0
    while f"decoder.generator.resblocks.{n_res}.convs1.0.weight_v" in sd or \
          f"decoder.generator.resblocks.{n_res}.convs1.0.weight" in sd:
        n_res += 1
    rk = []
    for j in range(n_res // max(len(rates), 1)):
        w = _fold_wn(sd, f"decoder.generator.resblocks.{j}.convs1.0")
        rk.append(w.shape[2])
    if not rates:
        return cfg
    return replace(
        cfg,
        upsample_rates=tuple(rates),
        upsample_kernels=tuple(kernels),
        upsample_initial=int(_fold_wn(sd, "decoder.generator.ups.0").shape[0]),
        resblock_kernels=tuple(rk) or cfg.resblock_kernels,
        resblock_dilations=((1, 3, 5),) * (len(rk) or len(cfg.resblock_kernels)),
    )


def _albert(sd):
    al = "bert.encoder.albert_layer_groups.0.albert_layers.0"
    return {
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


def _text_encoder(sd, cfg):
    out = {
        "embed": {"embedding": np.asarray(sd["text_encoder.embedding.weight"])},
        "lstm": _bilstm(sd, "text_encoder.lstm"),
    }
    for i in range(cfg.n_layer):
        out[f"conv_{i}"] = _conv1d(sd, f"text_encoder.cnn.{i}.0")
        out[f"ln_{i}"] = {
            "scale": np.asarray(sd[f"text_encoder.cnn.{i}.1.gamma"]),
            "bias": np.asarray(sd[f"text_encoder.cnn.{i}.1.beta"]),
        }
    return out


def _style_encoder_2d(sd, mod):
    """StyleEncoder: shared.0 stem, shared.1-4 ResBlks, shared.6 conv5x5,
    unshared linear."""
    out = {"stem": _conv2d_sn(sd, f"{mod}.shared.0")}
    for i in range(4):
        blk = f"{mod}.shared.{i + 1}"
        r = {
            "conv1": _conv2d_sn(sd, f"{blk}.conv1"),
            "conv2": _conv2d_sn(sd, f"{blk}.conv2"),
        }
        if f"{blk}.conv1x1.weight_orig" in sd or f"{blk}.conv1x1.weight" in sd:
            r["conv1x1"] = _conv2d_sn(sd, f"{blk}.conv1x1", bias=False)
        out[f"res{i}"] = r
    out["conv5"] = _conv2d_sn(sd, f"{mod}.shared.6")
    out["unshared"] = _dense(sd, f"{mod}.unshared")
    return out


def _predictor(sd, cfg):
    dur_enc = {}
    for i in range(cfg.n_layer):
        dur_enc[f"lstm_{i}"] = _bilstm(sd, f"predictor.text_encoder.lstms.{2 * i}")
        dur_enc[f"adaln_{i}"] = {"fc": _dense(sd, f"predictor.text_encoder.lstms.{2 * i + 1}.fc")}
    return {
        "dur_encoder": dur_enc,
        "pred_lstm": _bilstm(sd, "predictor.lstm"),
        "duration_proj": _dense(sd, "predictor.duration_proj.linear_layer"),
    }


def _prosody(sd):
    out = {"shared": _bilstm(sd, "predictor.shared")}
    for head, tkey in (("f0", "F0"), ("n", "N")):
        for i, up in enumerate((False, True, False)):
            out[f"{head}_{i}"] = _adain_resblk(sd, f"predictor.{tkey}.{i}", upsample=up)
        out[f"{head}_proj"] = _conv1d(sd, f"predictor.{tkey}_proj")
    return out


def _hifi_generator(sd, cfg):
    gen = {
        "m_source": {"l_linear": _dense(sd, "decoder.generator.m_source.l_linear")},
        "conv_post": _conv1d(sd, "decoder.generator.conv_post"),
    }
    n_k = len(cfg.resblock_kernels)
    for i in range(len(cfg.upsample_rates)):
        w = _fold_wn(sd, f"decoder.generator.ups.{i}")  # [in, out, k]
        gen[f"up_kernel_{i}"] = np.transpose(w, (2, 0, 1))
        gen[f"up_bias_{i}"] = np.asarray(sd[f"decoder.generator.ups.{i}.bias"])
        gen[f"noise_conv_{i}"] = _conv1d(sd, f"decoder.generator.noise_convs.{i}")
        gen[f"noise_res_{i}"] = _snake_resblock(
            sd, f"decoder.generator.noise_res.{i}", n=len(cfg.resblock_dilations[0])
        )
        for j in range(n_k):
            gen[f"resblock_{i}_{j}"] = _snake_resblock(
                sd, f"decoder.generator.resblocks.{i * n_k + j}",
                n=len(cfg.resblock_dilations[j]),
            )
    return gen


def _decoder(sd, cfg):
    dec = {
        "f0_conv": _conv1d(sd, "decoder.F0_conv"),
        "n_conv": _conv1d(sd, "decoder.N_conv"),
        "encode": _adain_resblk(sd, "decoder.encode"),
        "asr_res": _conv1d(sd, "decoder.asr_res.0"),
        "generator": _hifi_generator(sd, cfg),
    }
    for i, up in enumerate((False, False, False, True)):
        dec[f"decode_{i}"] = _adain_resblk(sd, f"decoder.decode.{i}", upsample=up)
    return dec


def _diffusion(sd, cfg, strict):
    """Best-effort map of the upstream StyleTransformer1d denoiser.

    The fused CoreML sampler the reference ships is an opaque re-trace of
    this module; our `StyleDenoiser` keeps its I/O contract (EDM-
    preconditioned x/sigma/embedding/features). Keys that line up with our
    layer names are mapped; the remainder is reported so partial conversions
    are visible rather than silent.
    """
    diff_keys = [k for k in sd if k.startswith("diffusion.")]
    mapped: dict = {}
    used: set[str] = set()
    # our own tree re-serialized (roundtrip path used by tests/tools)
    own = [k for k in diff_keys if ".to_in." in k or ".map_in." in k]
    if own:
        prefix = own[0].split(".to_in.")[0].split(".map_in.")[0]
        names = ["time_in", "feat_in", "map_in", "map_out", "to_in", "ctx_proj",
                 "ln_out", "to_out"]
        for i in range(cfg.diff_layers):
            names += [f"mod{i}", f"ln_a{i}", f"ln_c{i}", f"ln_f{i}",
                      f"ff1_{i}", f"ff2_{i}"]
        for name in names:
            wk, bk = f"{prefix}.{name}.weight", f"{prefix}.{name}.bias"
            if wk in sd:
                if name.startswith("ln"):
                    mapped[name] = {"scale": np.asarray(sd[wk]), "bias": np.asarray(sd[bk])}
                else:
                    mapped[name] = _dense(sd, f"{prefix}.{name}")
                used.update((wk, bk))
        # attention blocks (flax MHA layout: qkv kernels [d, H, Dh],
        # out kernel [H, Dh, d])
        H = cfg.diff_heads
        d = cfg.diff_width
        Dh = d // H
        for i in range(cfg.diff_layers):
            for name in (f"self{i}", f"cross{i}"):
                sub = {}
                for part in ("query", "key", "value", "out"):
                    wk = f"{prefix}.{name}.{part}.weight"
                    bk = f"{prefix}.{name}.{part}.bias"
                    if wk not in sd:
                        sub = None
                        break
                    w = np.asarray(sd[wk], np.float32)
                    b = np.asarray(sd[bk], np.float32)
                    if part == "out":
                        sub[part] = {"kernel": w.T.reshape(H, Dh, d), "bias": b}
                    else:
                        sub[part] = {"kernel": w.T.reshape(d, H, Dh),
                                     "bias": b.reshape(H, Dh)}
                    used.update((wk, bk))
                if sub:
                    mapped[name] = sub
        if f"{prefix}.pos" in sd:
            mapped["pos"] = np.asarray(sd[f"{prefix}.pos"])
            used.add(f"{prefix}.pos")
    unmapped = sorted(set(diff_keys) - used)
    if unmapped:
        msg = (f"style-diffusion: {len(unmapped)} upstream keys not mapped "
               f"(first: {unmapped[:3]}); denoiser keeps seeded init")
        if strict:
            raise ConversionError(msg)
        logger.warning(msg)
        return None
    return mapped or None


def convert_styletts2_checkpoint(
    ckpt: dict, cfg: StyleTts2Config | None = None, *, strict: bool = False
) -> tuple[dict[str, dict], StyleTts2Config]:
    """-> ({"text","style","predict","acoustic"} param trees, derived cfg)."""
    sd = flatten_net(ckpt)
    cfg = config_from_state_dict(sd, cfg)

    text = {
        "albert": _albert(sd),
        "bert_encoder": _dense(sd, "bert_encoder"),
        "text_encoder": _text_encoder(sd, cfg),
    }

    style = {
        "style_encoder": _style_encoder_2d(sd, "style_encoder"),
        "predictor_encoder": _style_encoder_2d(sd, "predictor_encoder"),
    }
    diff = _diffusion(sd, cfg, strict)
    if diff is not None:
        style["diffusion"] = diff

    predict = _predictor(sd, cfg)

    acoustic = {
        "prosody": _prosody(sd),
        "decoder": _decoder(sd, cfg),
    }

    return (
        {
            "text": {"params": text},
            "style": {"params": style},
            "predict": {"params": predict},
            "acoustic": {"params": acoustic},
        },
        cfg,
    )
