"""LS-EEND torch checkpoint -> flax params for LsEendModel.

The reference ships 4 fine-tunes of one LS-EEND architecture
(`ModelNames.swift:49-52`: ls-eend-coreml/optimized/{ami,ch,dih2,dih3}, each
at step sizes 100-500 ms). This converter maps a torch export of the frame
encoder + online attractor decoder onto `models/lseend.py`:

  enc.input_proj.{weight,bias}
  enc.layers.{i}.norm1/norm2.{weight,bias}
  enc.layers.{i}.self_attn.in_proj_weight/in_proj_bias,
  enc.layers.{i}.self_attn.out_proj.{weight,bias}
  enc.layers.{i}.fc1/fc2.{weight,bias}
  dec.slot_init                      [10, D] attractor bank init
  dec.cross_attn.in_proj_weight/in_proj_bias + out_proj (q from attractors,
      k/v from frames)
  dec.gate.{weight,bias} / dec.cand.{weight,bias}

torch MHA fused in_proj [3D, D] splits into flax per-head trees
({query,key,value}.kernel [D, H, Dh]); out_proj.weight [D, D] becomes
out.kernel [H, Dh, D]. One rename pass may be needed against a given
upstream LS-EEND release.
"""

from __future__ import annotations

import numpy as np

from fluidaudio_tpu_torch.models.lseend import MAX_SPEAKERS, LsEendConfig

LSEEND_VARIANTS = ("ami", "ch", "dih2", "dih3")  # ModelNames.swift:49-52


def _t(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _dense(sd, key):
    return {"kernel": _t(sd[f"{key}.weight"]), "bias": np.asarray(sd[f"{key}.bias"])}


def _ln(sd, key):
    return {"scale": np.asarray(sd[f"{key}.weight"]),
            "bias": np.asarray(sd[f"{key}.bias"])}


def _mha(sd, base, heads):
    """torch fused-MHA -> flax MultiHeadDotProductAttention tree."""
    w = np.asarray(sd[f"{base}.in_proj_weight"])  # [3D, D]
    b = np.asarray(sd[f"{base}.in_proj_bias"])
    D = w.shape[1]
    hd = D // heads
    out = {}
    for i, name in enumerate(("query", "key", "value")):
        wi = w[i * D : (i + 1) * D]  # [D, D] (out, in)
        bi = b[i * D : (i + 1) * D]
        out[name] = {
            "kernel": _t(wi).reshape(D, heads, hd),
            "bias": bi.reshape(heads, hd),
        }
    ow = np.asarray(sd[f"{base}.out_proj.weight"])  # [D, D]
    out["out"] = {
        "kernel": _t(ow).reshape(heads, hd, D),
        "bias": np.asarray(sd[f"{base}.out_proj.bias"]),
    }
    return out


def convert_lseend_state_dict(sd: dict, cfg: LsEendConfig) -> dict:
    p: dict = {
        "input_proj": _dense(sd, "enc.input_proj"),
        "slot_init": np.asarray(sd["dec.slot_init"]).reshape(
            MAX_SPEAKERS, cfg.d_model
        ),
        "slot_att": _mha(sd, "dec.cross_attn", cfg.n_heads),
        "gate": _dense(sd, "dec.gate"),
        "cand": _dense(sd, "dec.cand"),
    }
    for i in range(cfg.n_layers):
        b = f"enc.layers.{i}"
        p[f"ln{i}"] = _ln(sd, f"{b}.norm1")
        p[f"att{i}"] = _mha(sd, f"{b}.self_attn", cfg.n_heads)
        p[f"fln{i}"] = _ln(sd, f"{b}.norm2")
        p[f"ff1_{i}"] = _dense(sd, f"{b}.fc1")
        p[f"ff2_{i}"] = _dense(sd, f"{b}.fc2")
    return {"params": p}
