"""PocketTTS flow-LM + flow-decoder torch checkpoints -> flax params.

The flow LM targets the Moshi-style transformer layout (kyutai pocket-tts;
the reference consumes these weights as the opaque `cond_prefill`/`cond_step`/
`flowlm_step` CoreML graphs, `PocketTtsSynthesizer.swift:498-707`):

  text_emb.weight | emb.weight          -> text embedding [vocab, d]
  input_proj.weight | input_linear.weight -> latent input proj [d, 32]
  bos_emb | bos                          -> BOS embedding [d]
  transformer.layers.{i}.self_attn.in_proj_weight / out_proj.weight
  transformer.layers.{i}.norm1.alpha / norm2.alpha   (RMSNorm, [1,1,d] or [d])
  transformer.layers.{i}.gating.linear_in.weight / linear_out.weight
  out_norm.alpha
  eos_head.weight / eos_head.bias

The flow decoder uses this package's canonical names (the upstream fused
graph bakes 8 Euler steps; its pre-fusion torch module should be exported
with these keys — one rename pass may be needed against a given release):

  velocity.time_proj / velocity.in_proj / velocity.blk{i}.norm|fc1|fc2 /
  velocity.out_proj  (Linear weight/bias pairs; norm = LayerNorm)

Mimi weights are converted by `convert/mimi.py`.
"""

from __future__ import annotations

import numpy as np

from fluidaudio_tpu_torch.models.pocket_tts import PocketTtsConfig


def _t(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _first(sd, *names):
    for n in names:
        if n in sd:
            return np.asarray(sd[n])
    raise KeyError(f"none of {names} present")


def _rms(sd, *names):
    return {"scale": _first(sd, *names).reshape(-1)}


def convert_pocket_flowlm_state_dict(
    sd: dict, cfg: PocketTtsConfig | None = None
) -> dict:
    cfg = cfg or PocketTtsConfig()
    p: dict = {
        "text_embed": {"embedding": _first(sd, "text_emb.weight", "emb.weight")},
        "latent_embed": {
            "kernel": _t(_first(sd, "input_proj.weight", "input_linear.weight"))
        },
        "bos": _first(sd, "bos_emb", "bos").reshape(-1),
        "out_norm": _rms(sd, "out_norm.alpha", "out_norm.weight"),
        "eos_head": {
            "kernel": _t(_first(sd, "eos_head.weight")),
            "bias": _first(sd, "eos_head.bias"),
        },
    }
    for i in range(cfg.n_layers):
        b = f"transformer.layers.{i}"
        p[f"blk{i}"] = {
            "norm1": _rms(sd, f"{b}.norm1.alpha", f"{b}.norm1.weight"),
            "norm2": _rms(sd, f"{b}.norm2.alpha", f"{b}.norm2.weight"),
            "in_proj": {"kernel": _t(sd[f"{b}.self_attn.in_proj_weight"])},
            "out_proj": {"kernel": _t(sd[f"{b}.self_attn.out_proj.weight"])},
            "gate_in": {"kernel": _t(sd[f"{b}.gating.linear_in.weight"])},
            "gate_out": {"kernel": _t(sd[f"{b}.gating.linear_out.weight"])},
        }
    return {"params": p}


def convert_pocket_flow_decoder_state_dict(
    sd: dict, cfg: PocketTtsConfig | None = None
) -> dict:
    cfg = cfg or PocketTtsConfig()

    def lin(base):
        out = {"kernel": _t(sd[f"{base}.weight"])}
        if f"{base}.bias" in sd:
            out["bias"] = np.asarray(sd[f"{base}.bias"])
        return out

    v: dict = {
        "time_proj": lin("velocity.time_proj"),
        "in_proj": lin("velocity.in_proj"),
        "out_proj": lin("velocity.out_proj"),
    }
    for i in range(cfg.flow_blocks):
        v[f"blk{i}_norm"] = {
            "scale": np.asarray(sd[f"velocity.blk{i}.norm.weight"]),
            "bias": np.asarray(sd[f"velocity.blk{i}.norm.bias"]),
        }
        v[f"blk{i}_fc1"] = lin(f"velocity.blk{i}.fc1")
        v[f"blk{i}_fc2"] = lin(f"velocity.blk{i}.fc2")
    return {"params": {"velocity": v}}
