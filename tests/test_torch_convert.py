"""Checkpoint converters of the PyTorch port (`convert/`, ASR, VAD and
diarization) and its numpy `utils/checkpoint.py`, against the JAX package.

- `save_params`/`load_params`: the same flat keys in the same order as JAX's
  (dict keys sorted, `None` leaves dropped, list and tuple entries by index),
  the same dtypes, and the same errors on a missing, extra or mis-shaped key.
- Every converter, on the synthetic checkpoints JAX's own tests build
  (`tests/test_convert.py`, the converter cases of `test_cohere.py` and
  `test_lseend.py`): JAX's converter and the port's give the same tree (the
  same keys in the same order, equal arrays of equal dtype), and the file
  converters write the same npz. Each port npz loads through
  `utils/weights.load_npz` into its port module with every key consumed.
- JAX's converter cases that need no flax model run on the port
  (`jax_cases`): the sinc filters.
- The NeMo oracle of `tests/test_conformer_nemo_parity.py` through the
  port's converter and `ConformerEncoder`, full and ragged batches, at JAX's
  tolerance (atol 2e-4, rtol 2e-3).
"""

from __future__ import annotations

import dataclasses
import io
import subprocess
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidaudio_tpu.convert import cohere as j_cohere
from fluidaudio_tpu.convert import lseend as j_lseend
from fluidaudio_tpu.convert import paraformer as j_paraformer
from fluidaudio_tpu.convert import parakeet as j_parakeet
from fluidaudio_tpu.convert import pyannote as j_pyannote
from fluidaudio_tpu.convert import sensevoice as j_sensevoice
from fluidaudio_tpu.convert import silero as j_silero
from fluidaudio_tpu.convert import sortformer as j_sortformer
from fluidaudio_tpu.convert import streaming as j_streaming
from fluidaudio_tpu.convert import wespeaker as j_wespeaker
from fluidaudio_tpu.models import cohere_asr as j_cohere_asr
from fluidaudio_tpu.models import conformer as j_conformer
from fluidaudio_tpu.models import conformer_streaming as j_conformer_streaming
from fluidaudio_tpu.models import lseend as j_lseend_model
from fluidaudio_tpu.models import paraformer as j_paraformer_model
from fluidaudio_tpu.models import pyannote_seg as j_pyannote_seg
from fluidaudio_tpu.models import sensevoice as j_sensevoice_model
from fluidaudio_tpu.models import silero_vad as j_silero_vad
from fluidaudio_tpu.models import sortformer as j_sortformer_model
from fluidaudio_tpu.models import wespeaker as j_wespeaker_model
from fluidaudio_tpu.models.predictor import PredictorConfig as JPredictorConfig
from fluidaudio_tpu.models.zoo import ASR_VERSIONS as J_ASR_VERSIONS
from fluidaudio_tpu.utils import checkpoint as j_ckpt
from fluidaudio_tpu_torch import convert as p_convert_pkg
from fluidaudio_tpu_torch.convert import cohere as p_cohere
from fluidaudio_tpu_torch.convert import lseend as p_lseend
from fluidaudio_tpu_torch.convert import paraformer as p_paraformer
from fluidaudio_tpu_torch.convert import parakeet as p_parakeet
from fluidaudio_tpu_torch.convert import pyannote as p_pyannote
from fluidaudio_tpu_torch.convert import sensevoice as p_sensevoice
from fluidaudio_tpu_torch.convert import silero as p_silero
from fluidaudio_tpu_torch.convert import sortformer as p_sortformer
from fluidaudio_tpu_torch.convert import streaming as p_streaming
from fluidaudio_tpu_torch.convert import wespeaker as p_wespeaker
from fluidaudio_tpu_torch.models import cohere_asr as p_cohere_asr
from fluidaudio_tpu_torch.models import conformer as p_conformer
from fluidaudio_tpu_torch.models import conformer_streaming as p_conformer_streaming
from fluidaudio_tpu_torch.models import lseend as p_lseend_model
from fluidaudio_tpu_torch.models import paraformer as p_paraformer_model
from fluidaudio_tpu_torch.models import pyannote_seg as p_pyannote_seg
from fluidaudio_tpu_torch.models import sensevoice as p_sensevoice_model
from fluidaudio_tpu_torch.models import silero_vad as p_silero_vad
from fluidaudio_tpu_torch.models import sortformer as p_sortformer_model
from fluidaudio_tpu_torch.models import wespeaker as p_wespeaker_model
from fluidaudio_tpu_torch.models.predictor import RnntJoint, RnntPredictor
from fluidaudio_tpu_torch.models.zoo import ASR_VERSIONS, AsrModels
from fluidaudio_tpu_torch.utils import checkpoint as p_ckpt
from fluidaudio_tpu_torch.utils.weights import from_jax_params, load_npz, load_state
from tests.test_convert import (
    synthetic_nemo_state_dict,
    synthetic_paraformer_state_dict,
    synthetic_pyannote_state_dict,
    synthetic_sensevoice_state_dict,
    synthetic_silero_state_dict,
    synthetic_sortformer_state_dict,
    synthetic_wespeaker_state_dict,
)
from tests.test_torch_custom_vocab import jax_cases, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def port_config(cls, jax_cfg):
    """The port's dataclass `cls` with every field of the JAX config."""
    return cls(**{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)})


def assert_same_tree(want, got):
    """JAX's flat keys, in JAX's order, each array equal with its dtype."""
    w, g = j_ckpt._flatten(want), p_ckpt._flatten(got)
    assert list(g) == list(w)
    for key in w:
        assert g[key].dtype == w[key].dtype, key
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def assert_same_npz(want_path, got_path):
    with np.load(want_path) as w, np.load(got_path) as g:
        assert g.files == w.files
        for key in w.files:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def load_every_key(module, tree, path):
    """Save `tree` with the port's `save_params`, load the npz into `module`
    (raises on a missing, extra or mis-shaped key) -> the number of keys."""
    p_ckpt.save_params(path, tree)
    state = load_npz(path)
    load_state(module, state)
    assert len(state) == len(module.state_dict())
    return len(state)


# ------------------------------------------------------------ checkpoint I/O

def _mixed_tree():
    rs = np.random.RandomState(0)
    return {
        "params": {
            "zeta": {"kernel": rs.randn(3, 2).astype(np.float32), "bias": None},
            "alpha": [rs.randn(2).astype(np.float16), (np.arange(3, dtype=np.int64),
                                                        np.int8(-3))],
            "b10": {"scale": np.float64(1.5)},
            "b2": {"table": rs.randint(0, 9, (4, 2)).astype(np.int32)},
        },
        "step": 7,
    }


def test_save_params_writes_jax_s_keys_order_and_dtypes(tmp_path):
    tree = _mixed_tree()
    j_ckpt.save_params(tmp_path / "jax.npz", tree)
    p_ckpt.save_params(tmp_path / "sub" / "port.npz", tree)
    assert_same_npz(tmp_path / "jax.npz", tmp_path / "sub" / "port.npz")
    assert_same_tree(tree, tree)
    with np.load(tmp_path / "sub" / "port.npz") as data:
        assert "params/zeta/bias" not in data.files  # a None leaf is dropped
        assert data.files[:3] == ["params/alpha/0", "params/alpha/1/0", "params/alpha/1/1"]


def test_load_params_round_trips_and_casts_to_the_template(tmp_path):
    tree = _mixed_tree()
    p_ckpt.save_params(tmp_path / "t.npz", tree)
    template = _mixed_tree()
    template["params"]["b2"]["table"] = np.zeros((4, 2), np.float32)
    want = j_ckpt.load_params(tmp_path / "t.npz", template)
    got = p_ckpt.load_params(tmp_path / "t.npz", template)
    assert_same_tree(want, got)
    assert got["params"]["b2"]["table"].dtype == np.float32
    assert got["params"]["zeta"]["bias"] is None
    assert isinstance(got["params"]["alpha"], list) and isinstance(got["params"]["alpha"][1], tuple)


@pytest.mark.parametrize("change", ["missing", "extra", "shape"])
def test_load_params_raises_as_jax_does(tmp_path, change):
    tree = {"a": {"kernel": np.zeros((2, 3), np.float32)}, "b": np.ones(4, np.float32)}
    template = {"a": {"kernel": np.zeros((2, 3), np.float32)}, "b": np.ones(4, np.float32)}
    if change == "missing":
        del tree["b"]
    elif change == "extra":
        tree["c"] = np.zeros(1)
    else:
        tree["b"] = np.ones(5, np.float32)
    p_ckpt.save_params(tmp_path / "t.npz", tree)
    with pytest.raises(ValueError) as want:
        j_ckpt.load_params(tmp_path / "t.npz", template)
    with pytest.raises(ValueError) as got:
        p_ckpt.load_params(tmp_path / "t.npz", template)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------- converter equality

J_TINY, P_TINY = J_ASR_VERSIONS["test-tiny"], ASR_VERSIONS["test-tiny"]


class _P:  # the conformer key generator's decoder/joint dims, dropped after
    vocab_size, pred_hidden, joint_hidden, enc_hidden = 8, 8, 8, 8
    num_token_logits, n_durations, n_layers = 9, 2, 1


def _encoder_only(ccfg, rng):
    return {k: v for k, v in synthetic_nemo_state_dict(ccfg, _P, rng).items()
            if k.startswith("encoder.")}


def _streaming_cfgs():
    kw = dict(n_mels=16, d_model=32, n_layers=2, n_heads=4, att_context_left=8,
              subsampling_channels=16)
    return (j_conformer_streaming.StreamingConformerConfig(**kw),
            p_conformer_streaming.StreamingConformerConfig(**kw))


def _cohere_decoder_sd(cfg, rng):
    """`tests/test_cohere.py`'s synthetic transformer-decoder state dict."""
    D, FF = cfg.d_model, cfg.d_model * 4
    sd = {
        "decoder.embed_tokens.weight": rng.randn(cfg.vocab_size, D) * 0.05,
        "decoder.embed_positions.weight": rng.randn(cfg.max_decode_tokens, D) * 0.02,
        "decoder.layer_norm.weight": np.abs(rng.randn(D)) + 0.5,
        "decoder.layer_norm.bias": rng.randn(D) * 0.05,
    }
    for i in range(cfg.n_decoder_layers):
        b = f"decoder.layers.{i}"
        for ln in ("self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm"):
            sd[f"{b}.{ln}.weight"] = np.abs(rng.randn(D)) + 0.5
            sd[f"{b}.{ln}.bias"] = rng.randn(D) * 0.05
        for att in ("self_attn", "encoder_attn"):
            src = D if att == "self_attn" else cfg.enc_hidden
            for m, insz in (("q_proj", D), ("k_proj", src), ("v_proj", src), ("out_proj", D)):
                sd[f"{b}.{att}.{m}.weight"] = rng.randn(D, insz) * 0.05
                sd[f"{b}.{att}.{m}.bias"] = rng.randn(D) * 0.05
        sd[f"{b}.fc1.weight"] = rng.randn(FF, D) * 0.05
        sd[f"{b}.fc1.bias"] = rng.randn(FF) * 0.05
        sd[f"{b}.fc2.weight"] = rng.randn(D, FF) * 0.05
        sd[f"{b}.fc2.bias"] = rng.randn(D) * 0.05
    return sd


def _cohere_encoder_sd(cfg, rng):
    ccfg = j_cohere.cohere_conformer_config(cfg)
    pcfg = JPredictorConfig(vocab_size=8, pred_hidden=8, n_layers=1,
                            enc_hidden=ccfg.d_model, joint_hidden=8, n_durations=2)
    return synthetic_nemo_state_dict(ccfg, pcfg, rng)


def _lseend_sd(cfg, rng):
    """`tests/test_lseend.py`'s synthetic torch-layout state dict."""
    D, FF = cfg.d_model, cfg.d_model * 4

    def mha(base):
        return {
            f"{base}.in_proj_weight": rng.randn(3 * D, D) * 0.05,
            f"{base}.in_proj_bias": rng.randn(3 * D) * 0.05,
            f"{base}.out_proj.weight": rng.randn(D, D) * 0.05,
            f"{base}.out_proj.bias": rng.randn(D) * 0.05,
        }

    sd = {
        "enc.input_proj.weight": rng.randn(D, cfg.feat_dim) * 0.05,
        "enc.input_proj.bias": rng.randn(D) * 0.05,
        "dec.slot_init": rng.randn(j_lseend_model.MAX_SPEAKERS, D) * 0.05,
        "dec.gate.weight": rng.randn(D, 2 * D) * 0.05,
        "dec.gate.bias": rng.randn(D) * 0.05,
        "dec.cand.weight": rng.randn(D, D) * 0.05,
        "dec.cand.bias": rng.randn(D) * 0.05,
        **mha("dec.cross_attn"),
    }
    for i in range(cfg.n_layers):
        sd.update(mha(f"enc.layers.{i}.self_attn"))
        sd[f"enc.layers.{i}.norm1.weight"] = np.abs(rng.randn(D)) + 0.5
        sd[f"enc.layers.{i}.norm1.bias"] = rng.randn(D) * 0.05
        sd[f"enc.layers.{i}.norm2.weight"] = np.abs(rng.randn(D)) + 0.5
        sd[f"enc.layers.{i}.norm2.bias"] = rng.randn(D) * 0.05
        sd[f"enc.layers.{i}.fc1.weight"] = rng.randn(FF, D) * 0.05
        sd[f"enc.layers.{i}.fc1.bias"] = rng.randn(FF) * 0.05
        sd[f"enc.layers.{i}.fc2.weight"] = rng.randn(D, FF) * 0.05
        sd[f"enc.layers.{i}.fc2.bias"] = rng.randn(D) * 0.05
    return sd


_J_PYAN = j_pyannote_seg.PyanNetConfig(lstm_layers=2)
_J_WESP = j_wespeaker_model.WeSpeakerConfig.tiny()
_J_COHERE = j_cohere_asr.COHERE_TEST
_P_COHERE = p_cohere_asr.COHERE_TEST


def _conv_stage(name):
    """(state dict builder, JAX converter, port converter, [(npz part, subtree
    getter, port module builder)]) of one converter."""
    sst_j, sst_p = _streaming_cfgs()
    return {
        "parakeet": (
            lambda rng: synthetic_nemo_state_dict(J_TINY.conformer, J_TINY.predictor, rng),
            lambda sd: j_parakeet.convert_parakeet_state_dict(sd, J_TINY.conformer,
                                                              J_TINY.predictor),
            lambda sd: p_parakeet.convert_parakeet_state_dict(sd, P_TINY.conformer,
                                                              P_TINY.predictor),
            [("encoder", lambda t: t["encoder"],
              lambda: p_conformer.ConformerEncoder(P_TINY.conformer)),
             ("predictor", lambda t: t["predictor"], lambda: RnntPredictor(P_TINY.predictor)),
             ("joint", lambda t: t["joint"], lambda: RnntJoint(P_TINY.predictor))]),
        "streaming": (
            lambda rng: _encoder_only(j_conformer.ConformerConfig(
                n_mels=16, d_model=32, n_layers=2, n_heads=4, subsampling_channels=16), rng),
            lambda sd: j_streaming.convert_streaming_conformer_state_dict(sd, sst_j),
            lambda sd: p_streaming.convert_streaming_conformer_state_dict(sd, sst_p),
            [("encoder", lambda t: {"params": t},
              lambda: p_conformer_streaming.StreamingConformerEncoder(sst_p))]),
        "sortformer": (
            lambda rng: synthetic_sortformer_state_dict(j_sortformer_model.SORTFORMER_TEST, rng),
            lambda sd: j_sortformer.convert_sortformer_state_dict(
                sd, j_sortformer_model.SORTFORMER_TEST),
            lambda sd: p_sortformer.convert_sortformer_state_dict(
                sd, p_sortformer_model.SORTFORMER_TEST),
            [("sortformer", lambda t: {"params": t},
              lambda: p_sortformer_model.SortformerModel(p_sortformer_model.SORTFORMER_TEST))]),
        "cohere_encoder": (
            lambda rng: _cohere_encoder_sd(_J_COHERE, rng),
            lambda sd: j_cohere.convert_cohere_encoder_state_dict(sd, _J_COHERE),
            lambda sd: p_cohere.convert_cohere_encoder_state_dict(sd, _P_COHERE),
            [("encoder", lambda t: t, lambda: p_cohere_asr.CohereEncoder(_P_COHERE))]),
        "cohere_decoder": (
            lambda rng: _cohere_decoder_sd(_J_COHERE, rng),
            lambda sd: j_cohere.convert_cohere_decoder_state_dict(sd, _J_COHERE),
            lambda sd: p_cohere.convert_cohere_decoder_state_dict(sd, _P_COHERE),
            [("decoder", lambda t: t, lambda: p_cohere_asr.CohereDecoderStep(_P_COHERE))]),
        "sensevoice": (
            lambda rng: synthetic_sensevoice_state_dict(j_sensevoice_model.SENSEVOICE_TEST, rng),
            lambda sd: j_sensevoice.convert_sensevoice_state_dict(
                sd, j_sensevoice_model.SENSEVOICE_TEST),
            lambda sd: p_sensevoice.convert_sensevoice_state_dict(
                sd, p_sensevoice_model.SENSEVOICE_TEST),
            [("sensevoice", lambda t: {"params": t},
              lambda: p_sensevoice_model.SenseVoiceEncoder(p_sensevoice_model.SENSEVOICE_TEST))]),
        "paraformer": (
            lambda rng: synthetic_paraformer_state_dict(j_paraformer_model.PARAFORMER_TEST, rng),
            lambda sd: j_paraformer.convert_paraformer_state_dict(
                sd, j_paraformer_model.PARAFORMER_TEST),
            lambda sd: p_paraformer.convert_paraformer_state_dict(
                sd, p_paraformer_model.PARAFORMER_TEST),
            [("paraformer", lambda t: {"params": t},
              lambda: p_paraformer_model.Paraformer(p_paraformer_model.PARAFORMER_TEST))]),
        "silero": (
            lambda rng: synthetic_silero_state_dict(j_silero_vad.SileroV5Config(), rng),
            lambda sd: j_silero.convert_silero_state_dict(sd, j_silero_vad.SileroV5Config()),
            lambda sd: p_silero.convert_silero_state_dict(sd, p_silero_vad.SileroV5Config()),
            [("silero_vad", lambda t: {"params": t}, lambda: p_silero_vad.SileroVadV5())]),
        "pyannote": (
            lambda rng: synthetic_pyannote_state_dict(_J_PYAN, rng),
            lambda sd: j_pyannote.convert_pyannote_state_dict(sd, _J_PYAN),
            lambda sd: p_pyannote.convert_pyannote_state_dict(
                sd, port_config(p_pyannote_seg.PyanNetConfig, _J_PYAN)),
            [("segmentation", lambda t: {"params": t},
              lambda: p_pyannote_seg.PyanNet(port_config(p_pyannote_seg.PyanNetConfig, _J_PYAN)))]),
        "wespeaker": (
            lambda rng: synthetic_wespeaker_state_dict(_J_WESP, rng),
            lambda sd: j_wespeaker.convert_wespeaker_state_dict(sd, _J_WESP),
            lambda sd: p_wespeaker.convert_wespeaker_state_dict(
                sd, p_wespeaker_model.WeSpeakerConfig.tiny()),
            [("embedding", lambda t: {"params": t},
              lambda: p_wespeaker_model.WeSpeakerEmbedder(p_wespeaker_model.WeSpeakerConfig.tiny()))]),
        "lseend": (
            lambda rng: _lseend_sd(j_lseend_model.LSEEND_TEST, rng),
            lambda sd: j_lseend.convert_lseend_state_dict(sd, j_lseend_model.LSEEND_TEST),
            lambda sd: p_lseend.convert_lseend_state_dict(sd, p_lseend_model.LSEEND_TEST),
            [("lseend", lambda t: t, lambda: p_lseend_model.LsEendModel(p_lseend_model.LSEEND_TEST))]),
    }[name]


CONVERTERS = ["parakeet", "streaming", "sortformer", "cohere_encoder", "cohere_decoder",
              "sensevoice", "paraformer", "silero", "pyannote", "wespeaker", "lseend"]


@pytest.mark.parametrize("name", CONVERTERS)
def test_converter_tree_equals_jax(name):
    build, jax_fn, port_fn, _ = _conv_stage(name)
    sd = build(np.random.RandomState(0))
    assert_same_tree(jax_fn(dict(sd)), port_fn(dict(sd)))


@pytest.mark.parametrize("name", CONVERTERS)
def test_converted_npz_loads_with_every_key_consumed(name, tmp_path):
    build, _, port_fn, parts = _conv_stage(name)
    tree = port_fn(build(np.random.RandomState(1)))
    for part, subtree, module in parts:
        assert load_every_key(module(), subtree(tree), tmp_path / f"{part}.npz") > 0


def test_converters_take_torch_tensors_as_jax_does():
    """A state dict of torch tensors (what `torch.load` gives) converts to the
    same tree as its numpy arrays."""
    sd = synthetic_nemo_state_dict(J_TINY.conformer, J_TINY.predictor, np.random.RandomState(2))
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    want = j_parakeet.convert_parakeet_state_dict(
        {k: v.numpy() for k, v in tensors.items()}, J_TINY.conformer, J_TINY.predictor)
    assert_same_tree(want, p_parakeet.convert_parakeet_state_dict(
        tensors, P_TINY.conformer, P_TINY.predictor))


def test_joint_without_joint_net_drops_its_out_leaf(tmp_path):
    """A joint with no `joint_net` gives `out: None`, which both saves drop."""
    sd = synthetic_nemo_state_dict(J_TINY.conformer, J_TINY.predictor, np.random.RandomState(3))
    sd = {k: v for k, v in sd.items() if not k.startswith("joint.joint_net")}
    want = j_parakeet.convert_parakeet_state_dict(dict(sd), J_TINY.conformer, J_TINY.predictor)
    got = p_parakeet.convert_parakeet_state_dict(dict(sd), P_TINY.conformer, P_TINY.predictor)
    assert got["joint"]["params"]["out"] is None
    j_ckpt.save_params(tmp_path / "j.npz", want["joint"])
    p_ckpt.save_params(tmp_path / "p.npz", got["joint"])
    assert_same_npz(tmp_path / "j.npz", tmp_path / "p.npz")


# ------------------------------------------------------------ file converters

def _torch_save(sd, path, wrap=None, prefix=""):
    sd = {prefix + k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    torch.save({wrap: sd} if wrap else sd, path)


def _nemo_tar(path, ckpt_bytes, yaml_text=None):
    with tarfile.open(path, "w") as tar:
        for name, data in (("./model_weights.ckpt", ckpt_bytes),
                           *((("./model_config.yaml", yaml_text.encode()),) if yaml_text else ())):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


def _ckpt_bytes(sd):
    buf = io.BytesIO()
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, buf)
    return buf.getvalue()


@pytest.mark.parametrize("form", ["ckpt", "nemo", "nemo_yaml"])
def test_convert_nemo_file_writes_jax_s_npz(tmp_path, form):
    """A raw ckpt, a `.nemo` tar without `model_config.yaml` (the preset is
    kept), and one whose yaml overrides the preset's `n_layers` and `xscale`
    (the converter then reads those layers): both packages write the same
    encoder, predictor and joint npz, and the port's load into v3-shaped
    test-tiny modules with every key consumed."""
    rng = np.random.RandomState(4)
    jc, pc = J_TINY.conformer, P_TINY.conformer
    if form == "nemo_yaml":
        jc_big = dataclasses.replace(jc, n_layers=3)
        sd = synthetic_nemo_state_dict(jc_big, J_TINY.predictor, rng)
    else:
        sd = synthetic_nemo_state_dict(jc, J_TINY.predictor, rng)
    if form == "ckpt":
        src = tmp_path / "model.ckpt"
        _torch_save(sd, src)
    else:
        src = tmp_path / "model.nemo"
        yaml_text = ("encoder:\n  n_layers: 3\n  xscaling: false\n  d_model: 64\n"
                     if form == "nemo_yaml" else None)
        _nemo_tar(src, _ckpt_bytes(sd), yaml_text)
    j_parakeet.convert_nemo_file(src, tmp_path / "jax", jc, J_TINY.predictor)
    p_parakeet.convert_nemo_file(src, tmp_path / "port", pc, P_TINY.predictor)
    for part in ("encoder", "predictor", "joint"):
        assert_same_npz(tmp_path / "jax" / f"{part}.npz", tmp_path / "port" / f"{part}.npz")
    enc_cfg = dataclasses.replace(pc, n_layers=3, xscale=False) if form == "nemo_yaml" else pc
    for part, module in (("encoder", p_conformer.ConformerEncoder(enc_cfg)),
                         ("predictor", RnntPredictor(P_TINY.predictor)),
                         ("joint", RnntJoint(P_TINY.predictor))):
        load_state(module, load_npz(tmp_path / "port" / f"{part}.npz"))


def test_nemo_yaml_overrides_equal_jax(tmp_path):
    enc = {"d_model": 64, "n_layers": 5, "n_heads": 2, "conv_kernel_size": 31,
           "subsampling_conv_channels": 64, "feat_in": 80, "xscaling": False}
    yaml_text = "encoder:\n" + "".join(f"  {k}: {str(v).lower()}\n" for k, v in enc.items())
    _nemo_tar(tmp_path / "m.nemo", b"", yaml_text)
    assert p_parakeet.config_from_nemo_yaml(tmp_path / "m.nemo") == \
        j_parakeet.config_from_nemo_yaml(tmp_path / "m.nemo")
    got = p_parakeet.apply_nemo_encoder_yaml(P_TINY.conformer, enc)
    want = j_parakeet.apply_nemo_encoder_yaml(J_TINY.conformer, enc)
    assert {f.name: getattr(got, f.name) for f in dataclasses.fields(got)} == \
        {f.name: getattr(want, f.name) for f in dataclasses.fields(want)}
    _nemo_tar(tmp_path / "none.nemo", b"")
    with pytest.raises(FileNotFoundError):
        p_parakeet.config_from_nemo_yaml(tmp_path / "none.nemo")


def test_converted_nemo_loads_through_asr_models(tmp_path):
    """`convert_nemo_file` -> `AsrModels.load(checkpoint_dir=...,
    allow_random_init=False)` on the CPU: every key consumed, and the
    encoder's weights are the npz's."""
    sd = synthetic_nemo_state_dict(J_TINY.conformer, J_TINY.predictor, np.random.RandomState(5))
    _torch_save(sd, tmp_path / "model.ckpt")
    p_parakeet.convert_nemo_file(tmp_path / "model.ckpt", tmp_path / "out",
                                 P_TINY.conformer, P_TINY.predictor)
    models = AsrModels.load("test-tiny", checkpoint_dir=tmp_path / "out", device="cpu",
                            allow_random_init=False)
    state = load_npz(tmp_path / "out" / "encoder.npz")
    own = models.encoder.state_dict()
    assert set(own) == set(state)
    for key, value in state.items():
        np.testing.assert_array_equal(own[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("name", ["sortformer_nemo", "sortformer_raw", "sensevoice",
                                  "paraformer", "pyannote", "wespeaker", "silero"])
def test_file_converter_writes_jax_s_npz(tmp_path, name):
    rng = np.random.RandomState(6)
    src, jout, pout = tmp_path / "src", tmp_path / "jax.npz", tmp_path / "port.npz"
    if name.startswith("sortformer"):
        cfgs = (j_sortformer_model.SORTFORMER_TEST, p_sortformer_model.SORTFORMER_TEST)
        sd = synthetic_sortformer_state_dict(cfgs[0], rng)
        if name == "sortformer_nemo":
            _nemo_tar(src, _ckpt_bytes(sd))
        else:
            _torch_save(sd, src, wrap="state_dict")
        fns = (j_sortformer.convert_sortformer_file, p_sortformer.convert_sortformer_file)
    elif name == "sensevoice":
        cfgs = (j_sensevoice_model.SENSEVOICE_TEST, p_sensevoice_model.SENSEVOICE_TEST)
        _torch_save(synthetic_sensevoice_state_dict(cfgs[0], rng), src, wrap="state_dict")
        fns = (j_sensevoice.convert_sensevoice_file, p_sensevoice.convert_sensevoice_file)
    elif name == "paraformer":
        cfgs = (j_paraformer_model.PARAFORMER_TEST, p_paraformer_model.PARAFORMER_TEST)
        _torch_save(synthetic_paraformer_state_dict(cfgs[0], rng), src)
        fns = (j_paraformer.convert_paraformer_file, p_paraformer.convert_paraformer_file)
    elif name == "pyannote":
        cfgs = (_J_PYAN, port_config(p_pyannote_seg.PyanNetConfig, _J_PYAN))
        _torch_save(synthetic_pyannote_state_dict(_J_PYAN, rng), src, wrap="state_dict",
                    prefix="model.")
        fns = (j_pyannote.convert_pyannote_file, p_pyannote.convert_pyannote_file)
    elif name == "wespeaker":
        cfgs = (_J_WESP, p_wespeaker_model.WeSpeakerConfig.tiny())
        _torch_save(synthetic_wespeaker_state_dict(_J_WESP, rng), src,
                    prefix="speaker_extractor.")
        fns = (j_wespeaker.convert_wespeaker_file, p_wespeaker.convert_wespeaker_file)
    else:  # not a TorchScript archive: both fall back to a plain torch.load
        cfgs = (j_silero_vad.SileroV5Config(), p_silero_vad.SileroV5Config())
        _torch_save(synthetic_silero_state_dict(cfgs[0], rng), src)
        fns = (j_silero.convert_silero_file, p_silero.convert_silero_file)
    fns[0](src, jout, cfgs[0])
    fns[1](src, pout, cfgs[1])
    assert_same_npz(jout, pout)


def test_silero_file_reads_a_torchscript_archive(tmp_path):
    """`convert_silero_file` reads a TorchScript archive's state dict through
    `torch.jit.load`, as upstream ships `silero_vad.jit`: both packages write
    the same npz."""
    sd = synthetic_silero_state_dict(j_silero_vad.SileroV5Config(), np.random.RandomState(7))

    class Root(torch.nn.Module):
        def forward(self, x: torch.Tensor) -> torch.Tensor:
            return x

    root = Root()
    for key, value in sd.items():
        *owners, leaf = key.split(".")
        mod = root
        for name in owners:
            if not hasattr(mod, name):
                mod.add_module(name, torch.nn.Module())
            mod = getattr(mod, name)
        mod.register_buffer(leaf, torch.from_numpy(value))
    torch.jit.save(torch.jit.script(root), tmp_path / "silero_vad.jit")
    assert set(torch.jit.load(tmp_path / "silero_vad.jit").state_dict()) == set(sd)
    j_silero.convert_silero_file(tmp_path / "silero_vad.jit", tmp_path / "jax.npz")
    p_silero.convert_silero_file(tmp_path / "silero_vad.jit", tmp_path / "port.npz")
    assert_same_npz(tmp_path / "jax.npz", tmp_path / "port.npz")


# ------------------------------------------------------------ JAX's cases

@pytest.mark.parametrize("case", jax_cases("test_convert.py", ("convert.pyannote",),
                                           ("test_sinc_filters_are_bandpass",)))
def test_jax_convert_case_on_the_port(case):
    case()


def test_sinc_filters_equal_jax_bit_for_bit():
    rs = np.random.RandomState(8)
    low, band = np.abs(rs.randn(16, 1)) * 500, np.abs(rs.randn(16, 1)) * 200
    for k in (251, 129):
        want = j_pyannote.materialize_sinc_filters(low, band, k)
        got = p_pyannote.materialize_sinc_filters(low, band, k)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ NeMo oracle

def _oracle_module():
    import tests.test_conformer_nemo_parity as parity

    return parity


@pytest.fixture(scope="module")
def oracle_and_port():
    parity = _oracle_module()
    cfg = parity.CFG
    torch.manual_seed(7)
    oracle = parity.OracleEncoder(cfg.n_mels, cfg.subsampling_channels, cfg.d_model,
                                  cfg.n_heads, cfg.n_layers, cfg.conv_kernel, xscale=True).eval()
    pcfg = p_conformer.ConformerConfig(
        n_mels=cfg.n_mels, d_model=cfg.d_model, n_layers=cfg.n_layers, n_heads=cfg.n_heads,
        conv_kernel=cfg.conv_kernel, subsampling_channels=cfg.subsampling_channels,
        dtype="float32", xscale=True)
    params = p_parakeet.convert_conformer_encoder(oracle.nemo_state_dict(), pcfg)
    enc = p_conformer.ConformerEncoder(pcfg).eval()
    load_state(enc, from_jax_params(p_ckpt._flatten({"params": params})))
    return oracle, enc, cfg


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_port_converter_and_encoder_match_the_nemo_oracle(oracle_and_port, ragged):
    oracle, enc, cfg = oracle_and_port
    rng = np.random.RandomState(1 if ragged else 0)
    T_mel = 64
    mel = rng.randn(2, cfg.n_mels, T_mel).astype(np.float32)
    lengths = np.array([T_mel, 40 if ragged else T_mel], np.int32)
    if ragged:
        mel[1, :, 40:] = 0.0
    with torch.no_grad():
        ref, ref_len = oracle(torch.from_numpy(mel), torch.from_numpy(lengths))
        got, got_len = enc(torch.from_numpy(mel), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_len.numpy(), ref_len.numpy())
    for b in range(2):
        n = int(got_len[b])
        np.testing.assert_allclose(got.numpy()[b, :n], ref.numpy()[b, :n], atol=2e-4, rtol=2e-3)


# ------------------------------------------------------------ the package

def test_convert_package_exports_jax_s_names():
    from fluidaudio_tpu import convert as j_convert_pkg

    assert p_convert_pkg.__all__ == j_convert_pkg.__all__
    for name in p_convert_pkg.__all__:
        assert getattr(p_convert_pkg, name).__module__.startswith("fluidaudio_tpu_torch.convert.")


def test_every_jax_converter_module_has_a_port_with_its_public_names():
    import importlib
    import inspect

    jax_dir = REPO / "fluidaudio_tpu" / "convert"
    names = sorted(p.stem for p in jax_dir.glob("*.py"))
    assert len(names) == 21
    assert names == sorted(p.stem for p in (REPO / "fluidaudio_tpu_torch" / "convert").glob("*.py"))
    for stem in names:
        if stem == "__init__":
            continue
        jm = importlib.import_module(f"fluidaudio_tpu.convert.{stem}")
        pm = importlib.import_module(f"fluidaudio_tpu_torch.convert.{stem}")
        for name, obj in vars(jm).items():
            if name.startswith("_") or inspect.ismodule(obj):
                continue
            if getattr(obj, "__module__", jm.__name__) != jm.__name__:
                continue  # imported from elsewhere (configs, numpy)
            assert hasattr(pm, name), (stem, name)


def test_the_converters_import_no_jax():
    code = ("import importlib, pkgutil, sys, fluidaudio_tpu_torch.convert as c;"
            "import fluidaudio_tpu_torch.utils.checkpoint;"
            "[importlib.import_module(m.name) for m in "
            "pkgutil.walk_packages(c.__path__, 'fluidaudio_tpu_torch.convert.')];"
            "assert len([m for m in sys.modules if m.startswith('fluidaudio_tpu_torch.convert.')]) == 20;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'jaxlib', 'fluidaudio_tpu')]; print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
