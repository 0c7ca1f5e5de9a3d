"""Checkpoint converters of the PyTorch port for TTS and G2P (Kokoro,
StyleTTS2, Mimi, PocketTTS, Supertonic-3 with the ONNX reader and writer,
BART, ByT5, g2pW), against the JAX package.

- Every converter, on the synthetic checkpoints JAX's own tests build
  (`tests/test_convert_{kokoro,styletts2}.py`, `test_mimi.py`,
  `test_pocket_tts.py`, `test_supertonic3_convert.py`, and seeded
  `transformers` models as `test_convert_{bart,byt5,g2pw}.py` build them):
  JAX's converter and the port's give the same tree (the same keys in the
  same order, equal arrays of equal dtype). Each port tree, saved with the
  port's `save_params`, loads through `utils/weights.load_npz` into its
  port module with every key consumed.
- The ONNX writer writes JAX's bytes; the reader parses them to JAX's
  tensors, attributes and node stream; JAX's six ONNX-reader cases run on
  the port (`jax_cases`), as do the Karras, `round_durations`,
  `flatten_net` and `config_from_state_dict` cases of StyleTTS2.
- `Supertonic3Manager` on a staged test-width ONNX release with no npz:
  the port converts it in place, as JAX does, and synthesizes JAX's audio
  within `tests/test_torch_supertonic.py`'s tolerance.
"""

from __future__ import annotations

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from fluidaudio_tpu.convert import bart as j_bart
from fluidaudio_tpu.convert import byt5 as j_byt5
from fluidaudio_tpu.convert import g2pw as j_g2pw
from fluidaudio_tpu.convert import kokoro as j_kokoro
from fluidaudio_tpu.convert import mimi as j_mimi
from fluidaudio_tpu.convert import onnx_reader as j_onnx_reader
from fluidaudio_tpu.convert import onnx_writer as j_onnx_writer
from fluidaudio_tpu.convert import pocket_tts as j_pocket
from fluidaudio_tpu.convert import styletts2 as j_styletts2
from fluidaudio_tpu.convert import supertonic3 as j_st3
from fluidaudio_tpu.models import bart_g2p as j_bart_model
from fluidaudio_tpu.models import bert_g2pw as j_g2pw_model
from fluidaudio_tpu.models import byt5_g2p as j_byt5_model
from fluidaudio_tpu.models import mimi as j_mimi_model
from fluidaudio_tpu.models import pocket_tts as j_pocket_model
from fluidaudio_tpu.models import supertonic3 as j_st3_model
from fluidaudio_tpu.tts import supertonic_manager as j_st3_mgr
from fluidaudio_tpu_torch.convert import bart as p_bart
from fluidaudio_tpu_torch.convert import byt5 as p_byt5
from fluidaudio_tpu_torch.convert import g2pw as p_g2pw
from fluidaudio_tpu_torch.convert import kokoro as p_kokoro
from fluidaudio_tpu_torch.convert import mimi as p_mimi
from fluidaudio_tpu_torch.convert import onnx_reader as p_onnx_reader
from fluidaudio_tpu_torch.convert import onnx_writer as p_onnx_writer
from fluidaudio_tpu_torch.convert import pocket_tts as p_pocket
from fluidaudio_tpu_torch.convert import styletts2 as p_styletts2
from fluidaudio_tpu_torch.convert import supertonic3 as p_st3
from fluidaudio_tpu_torch.models import bart_g2p as p_bart_model
from fluidaudio_tpu_torch.models import bert_g2pw as p_g2pw_model
from fluidaudio_tpu_torch.models import byt5_g2p as p_byt5_model
from fluidaudio_tpu_torch.models import kokoro as p_kokoro_model
from fluidaudio_tpu_torch.models import mimi as p_mimi_model
from fluidaudio_tpu_torch.models import pocket_tts as p_pocket_model
from fluidaudio_tpu_torch.models import styletts2 as p_styletts2_model
from fluidaudio_tpu_torch.models import supertonic3 as p_st3_model
from fluidaudio_tpu_torch.tts import supertonic_manager as p_st3_mgr
from fluidaudio_tpu_torch.utils import checkpoint as p_ckpt
from fluidaudio_tpu_torch.utils.weights import load_npz, load_state
from tests.test_convert_kokoro import synthetic_kokoro_state_dict
from tests.test_convert_kokoro import tiny_cfg as kokoro_tiny_cfg
from tests.test_convert_styletts2 import synthetic_styletts2_state_dict
from tests.test_convert_styletts2 import tiny_cfg as styletts2_tiny_cfg
from tests.test_mimi import synthetic_mimi_state_dict
from tests.test_pocket_tts import synthetic_flow_decoder_state_dict, synthetic_flowlm_state_dict
from tests.test_torch_convert import assert_same_npz, assert_same_tree, load_every_key, port_config
from tests.test_torch_custom_vocab import jax_cases, one_torch_thread  # noqa: F401
from tests.test_torch_supertonic import REL_L2_AUDIO, _rel

transformers = pytest.importorskip("transformers")


# ------------------------------------------------------------ Kokoro, StyleTTS2

def _kokoro_cfgs():
    j = kokoro_tiny_cfg()
    return j, port_config(p_kokoro_model.KokoroConfig, j)


def _styletts2_cfgs():
    j = styletts2_tiny_cfg()
    return j, port_config(p_styletts2_model.StyleTts2Config, j)


def test_kokoro_tree_equals_jax_and_loads_every_key(tmp_path):
    jc, pc = _kokoro_cfgs()
    sd = synthetic_kokoro_state_dict(jc, np.random.RandomState(0))
    want = j_kokoro.convert_kokoro_state_dict(dict(sd), jc)
    got = p_kokoro.convert_kokoro_state_dict(dict(sd), pc)
    assert_same_tree(want, got)
    assert load_every_key(p_kokoro_model.KokoroTextProgram(pc), got["text"], tmp_path / "t.npz")
    assert load_every_key(p_kokoro_model.KokoroAudioProgram(pc, deterministic=True), got["audio"],
                          tmp_path / "a.npz")


def test_kokoro_module_prefix_is_stripped_as_in_jax():
    """Kokoro's `.pth` nests `module.`-prefixed keys; both strip it once."""
    jc, pc = _kokoro_cfgs()
    sd = {"module." + k: v for k, v in
          synthetic_kokoro_state_dict(jc, np.random.RandomState(1)).items()}
    assert_same_tree(j_kokoro.convert_kokoro_state_dict(dict(sd), jc),
                     p_kokoro.convert_kokoro_state_dict(dict(sd), pc))


def test_styletts2_trees_and_config_equal_jax_and_load_every_key(tmp_path):
    jc, pc = _styletts2_cfgs()
    sd = synthetic_styletts2_state_dict(jc, np.random.RandomState(0))
    want, want_cfg = j_styletts2.convert_styletts2_checkpoint(dict(sd), jc)
    got, got_cfg = p_styletts2.convert_styletts2_checkpoint(dict(sd), pc)
    assert_same_tree(want, got)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    programs = {"text": p_styletts2_model.StyleTts2TextProgram,
                "predict": p_styletts2_model.StyleTts2PredictProgram,
                "acoustic": p_styletts2_model.StyleTts2AcousticProgram}
    for part, cls in programs.items():
        assert load_every_key(cls(got_cfg), got[part], tmp_path / f"{part}.npz")
    # the synthetic checkpoint has no diffusion tree (the upstream denoiser is
    # not mapped): the style program takes the encoders' keys, each consumed,
    # and keeps its own diffusion weights
    style = p_styletts2_model.StyleTts2StyleProgram(got_cfg)
    p_ckpt.save_params(tmp_path / "style.npz", got["style"])
    state = load_npz(tmp_path / "style.npz")
    own = style.state_dict()
    assert set(state) <= set(own)
    assert {k.split(".")[0] for k in set(own) - set(state)} == {"diffusion"}
    load_state(style, {**{k: v for k, v in own.items() if k not in state}, **state})


def test_styletts2_nested_checkpoint_equals_jax():
    """An upstream `{"net": {...}}` checkpoint with `module.` prefixes."""
    jc, pc = _styletts2_cfgs()
    sd = synthetic_styletts2_state_dict(jc, np.random.RandomState(2))
    nested = {"net": {}}
    for k, v in sd.items():
        top, rest = k.split(".", 1)
        nested["net"].setdefault(top, {})["module." + rest] = v
    want, _ = j_styletts2.convert_styletts2_checkpoint(nested, jc)
    got, _ = p_styletts2.convert_styletts2_checkpoint(nested, pc)
    assert_same_tree(want, got)


STYLETTS2_CASES = ("test_karras_schedule_matches_reference_formula",
                   "test_round_durations_semantics", "test_flatten_net_nested_and_flat",
                   "test_config_from_state_dict_derives_rates")


@pytest.mark.parametrize("case", jax_cases("test_convert_styletts2.py",
                                           ("convert.styletts2", "models.styletts2"),
                                           STYLETTS2_CASES))
def test_jax_styletts2_case_on_the_port(case):
    case()


# ------------------------------------------------------------ Mimi, PocketTTS

def test_mimi_trees_equal_jax_and_load_every_key(tmp_path):
    jc, pc = j_mimi_model.MIMI_TEST, p_mimi_model.MIMI_TEST
    sd = synthetic_mimi_state_dict(jc, np.random.RandomState(0))
    dec_w, dec_g = (j_mimi.convert_mimi_decoder_state_dict(dict(sd), jc),
                    p_mimi.convert_mimi_decoder_state_dict(dict(sd), pc))
    enc_w, enc_g = (j_mimi.convert_mimi_encoder_state_dict(dict(sd), jc),
                    p_mimi.convert_mimi_encoder_state_dict(dict(sd), pc))
    assert_same_tree(dec_w, dec_g)
    assert_same_tree(enc_w, enc_g)
    assert load_every_key(p_mimi_model.MimiDecoder(pc), dec_g, tmp_path / "dec.npz")
    assert load_every_key(p_mimi_model.MimiEncoder(pc), enc_g, tmp_path / "enc.npz")


def test_pocket_trees_equal_jax_and_load_every_key(tmp_path):
    jc, pc = j_pocket_model.POCKET_TEST, p_pocket_model.POCKET_TEST
    rng = np.random.RandomState(0)
    lm_sd, fd_sd = synthetic_flowlm_state_dict(jc, rng), synthetic_flow_decoder_state_dict(jc, rng)
    lm_w, lm_g = (j_pocket.convert_pocket_flowlm_state_dict(dict(lm_sd), jc),
                  p_pocket.convert_pocket_flowlm_state_dict(dict(lm_sd), pc))
    fd_w, fd_g = (j_pocket.convert_pocket_flow_decoder_state_dict(dict(fd_sd), jc),
                  p_pocket.convert_pocket_flow_decoder_state_dict(dict(fd_sd), pc))
    assert_same_tree(lm_w, lm_g)
    assert_same_tree(fd_w, fd_g)
    assert load_every_key(p_pocket_model.FlowLm(pc), lm_g, tmp_path / "lm.npz")
    assert load_every_key(p_pocket_model.FlowDecoder(pc), fd_g, tmp_path / "fd.npz")


# ------------------------------------------------------------ G2P (HF state dicts)

def _hf_bart():
    c = j_bart_model.BART_G2P_TEST
    cfg = transformers.BartConfig(
        vocab_size=c.vocab_size, d_model=c.d_model, encoder_layers=c.encoder_layers,
        decoder_layers=c.decoder_layers, encoder_attention_heads=c.encoder_attention_heads,
        decoder_attention_heads=c.decoder_attention_heads, encoder_ffn_dim=c.encoder_ffn_dim,
        decoder_ffn_dim=c.decoder_ffn_dim, max_position_embeddings=c.max_position_embeddings,
        scale_embedding=c.scale_embedding, pad_token_id=c.pad_token_id,
        bos_token_id=c.bos_token_id, eos_token_id=c.eos_token_id,
        decoder_start_token_id=c.decoder_start_token_id, forced_eos_token_id=None,
        forced_bos_token_id=None, activation_function="gelu",
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
    torch.manual_seed(1)
    return transformers.BartForConditionalGeneration(cfg).eval()


def _hf_byt5():
    c = j_byt5_model.BYT5_TEST
    cfg = transformers.T5Config(
        vocab_size=c.vocab_size, d_model=c.d_model, d_kv=c.d_kv, d_ff=c.d_ff,
        num_layers=c.num_layers, num_decoder_layers=c.num_decoder_layers, num_heads=c.num_heads,
        relative_attention_num_buckets=c.relative_attention_num_buckets,
        relative_attention_max_distance=c.relative_attention_max_distance,
        feed_forward_proj="gated-gelu", tie_word_embeddings=False, decoder_start_token_id=0,
        dropout_rate=0.0)
    torch.manual_seed(0)
    return transformers.T5ForConditionalGeneration(cfg).eval()


def _hf_g2pw():
    c = j_g2pw_model.G2PW_TEST
    cfg = transformers.BertConfig(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size, num_hidden_layers=c.num_hidden_layers,
        num_attention_heads=c.num_attention_heads, intermediate_size=c.intermediate_size,
        max_position_embeddings=c.max_position_embeddings, type_vocab_size=c.type_vocab_size,
        hidden_act="gelu", hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = transformers.BertModel(cfg, add_pooling_layer=False).eval()
    head = torch.nn.Linear(c.hidden_size, c.num_labels)
    sd = {"bert." + k: v for k, v in hf.state_dict().items()}
    sd["classifier.weight"], sd["classifier.bias"] = head.weight, head.bias
    return hf, sd


G2P = {
    "bart": (lambda: (lambda hf: (hf.config.to_dict(), hf.state_dict()))(_hf_bart()),
             j_bart, p_bart, j_bart_model.BART_G2P_TEST, p_bart_model.BART_G2P_TEST,
             lambda cfg: p_bart_model.BartG2P(cfg)),
    "byt5": (lambda: (lambda hf: (hf.config.to_dict(), hf.state_dict()))(_hf_byt5()),
             j_byt5, p_byt5, j_byt5_model.BYT5_TEST, p_byt5_model.BYT5_TEST,
             lambda cfg: p_byt5_model.ByT5G2P(cfg)),
    "g2pw": (lambda: (lambda pair: (pair[0].config.to_dict(), pair[1]))(_hf_g2pw()),
             j_g2pw, p_g2pw, j_g2pw_model.G2PW_TEST, p_g2pw_model.G2PW_TEST,
             lambda cfg: p_g2pw_model.BertG2pw(cfg)),
}


@pytest.mark.parametrize("name", sorted(G2P))
def test_g2p_tree_and_config_equal_jax_and_load_every_key(name, tmp_path):
    hf_cfg, sd = G2P[name][0]()
    jm, pm, jcfg, pcfg, module = G2P[name][1:]
    convert = f"convert_{name}_state_dict"
    want = getattr(jm, convert)(dict(sd), jcfg)
    got = getattr(pm, convert)(dict(sd), pcfg)
    assert_same_tree(want, got)
    extra = {"num_labels": pcfg.num_labels} if name == "g2pw" else {}
    assert vars(pm.config_from_hf(hf_cfg, **extra)) == vars(jm.config_from_hf(hf_cfg, **extra))
    assert vars(pm.config_from_hf(hf_cfg, **extra)) == vars(pcfg)
    assert load_every_key(module(pcfg), got, tmp_path / f"{name}.npz")


@pytest.mark.parametrize("name", sorted(G2P))
def test_g2p_missing_key_raises_jax_s_error(name):
    hf_cfg, sd = G2P[name][0]()
    jm, pm, jcfg, pcfg, _ = G2P[name][1:]
    sd = dict(sd)
    del sd[sorted(sd)[len(sd) // 2]]
    convert = f"convert_{name}_state_dict"
    with pytest.raises(jm.ConversionError) as want:
        getattr(jm, convert)(dict(sd), jcfg)
    with pytest.raises(pm.ConversionError) as got:
        getattr(pm, convert)(dict(sd), pcfg)
    assert str(got.value) == str(want.value)


def test_models_re_export_the_converters_config_from_hf():
    """`config_from_hf` has one definition in the port, in `convert/`; the
    model modules that had their own copies re-export it."""
    assert p_bart_model.config_from_hf is p_bart.config_from_hf
    assert p_byt5_model.config_from_hf is p_byt5.config_from_hf
    assert p_g2pw_model.config_from_hf is p_g2pw.config_from_hf


def test_lseend_variants_have_one_definition():
    from fluidaudio_tpu.convert.lseend import LSEEND_VARIANTS as jax_variants
    from fluidaudio_tpu_torch.convert import lseend as p_lseend
    from fluidaudio_tpu_torch.diarizer import lseend as p_lseend_diarizer

    assert p_lseend_diarizer.LSEEND_VARIANTS is p_lseend.LSEEND_VARIANTS
    assert p_lseend.LSEEND_VARIANTS == jax_variants


# ------------------------------------------------------------ ONNX

ONNX_READER_CASES = jax_cases("test_onnx_reader.py", ("convert.onnx_reader",), fixtures=True)


@pytest.mark.parametrize("case", ONNX_READER_CASES)
def test_jax_onnx_reader_case_on_the_port(case, request):
    case(request)


def test_jax_onnx_reader_cases_are_all_six():
    assert len(ONNX_READER_CASES) == 6


def _onnx_payload():
    rs = np.random.RandomState(0)
    tensors = {
        "w": rs.randn(3, 4).astype(np.float32),
        "h": rs.randn(5).astype(np.float16),
        "i": np.array([-3, 0, 1 << 40], np.int64),
        "b": np.array([1, -1, 7], np.int32),
    }
    nodes = [("Conv", ["x", "w"], ["y"], "conv0", {"strides": [1, 2], "group": 1, "alpha": 0.5}),
             ("MatMul", ["y", "h"], ["z"], "", {}),
             ("Gather", ["i", "z"], ["out"], "g", {"mode": b"nearest", "axis": -1,
                                                  "keep": True, "pads": [-1, 2]})]
    return tensors, nodes


def test_onnx_writer_writes_jax_s_bytes(tmp_path):
    tensors, nodes = _onnx_payload()
    for name, arr in tensors.items():
        assert p_onnx_writer.encode_tensor(name, arr) == j_onnx_writer.encode_tensor(name, arr)
    for node in nodes:
        assert p_onnx_writer.encode_node(*node) == j_onnx_writer.encode_node(*node)
    encoded = [j_onnx_writer.encode_node(*n) for n in nodes]
    j_onnx_writer.write_onnx(tmp_path / "j.onnx", encoded, tensors)
    p_onnx_writer.write_onnx(tmp_path / "p.onnx", encoded, tensors)
    assert (tmp_path / "p.onnx").read_bytes() == (tmp_path / "j.onnx").read_bytes()
    with pytest.raises(ValueError, match="unsupported dtype"):
        p_onnx_writer.encode_tensor("c", np.zeros(2, np.complex64))


def test_onnx_reader_parses_as_jax_does(tmp_path):
    tensors, nodes = _onnx_payload()
    j_onnx_writer.write_onnx(tmp_path / "m.onnx", [j_onnx_writer.encode_node(*n) for n in nodes],
                             tensors)
    want_t, want_ops = j_onnx_reader.read_onnx(tmp_path / "m.onnx")
    got_t, got_ops = p_onnx_reader.read_onnx(tmp_path / "m.onnx")
    assert got_ops == want_ops and list(got_t) == list(want_t)
    for k in want_t:
        assert got_t[k].dtype == want_t[k].dtype
        np.testing.assert_array_equal(got_t[k], want_t[k])
    jg = j_onnx_reader.read_onnx_graph(tmp_path / "m.onnx")
    pg = p_onnx_reader.read_onnx_graph(tmp_path / "m.onnx")
    assert [(n.op_type, n.name, n.inputs, n.outputs, n.attrs) for n in pg.nodes] == \
        [(n.op_type, n.name, n.inputs, n.outputs, n.attrs) for n in jg.nodes]
    assert [(n.op_type, pos, name, shape) for n, pos, name, shape in pg.weight_events()] == \
        [(n.op_type, pos, name, shape) for n, pos, name, shape in jg.weight_events()]
    (tmp_path / "bad.onnx").write_bytes(b"\xff\xff\xff")
    with pytest.raises(j_onnx_reader.OnnxParseError) as want:
        j_onnx_reader.read_onnx(tmp_path / "bad.onnx")
    with pytest.raises(p_onnx_reader.OnnxParseError) as got:
        p_onnx_reader.read_onnx(tmp_path / "bad.onnx")
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ Supertonic-3

J_ST3, P_ST3 = j_st3_model.SUPERTONIC3_TEST, p_st3_model.SUPERTONIC3_TEST


@pytest.fixture(scope="module")
def st3_release(tmp_path_factory):
    """A test-width Supertonic-3 ONNX release written by each package's
    `synthesize_supertonic3_fixture` from one seed."""
    root = tmp_path_factory.mktemp("st3")
    truth_j = j_st3.synthesize_supertonic3_fixture(root / "jax", J_ST3, seed=0)
    truth_p = p_st3.synthesize_supertonic3_fixture(root / "port", P_ST3, seed=0)
    return root, truth_j, truth_p


def test_supertonic3_fixture_and_conversion_equal_jax(st3_release, tmp_path):
    root, truth_j, truth_p = st3_release
    assert_same_tree(truth_j, truth_p)
    for stage in p_st3.STAGES:
        assert (root / "port" / f"{stage}.onnx").read_bytes() == \
            (root / "jax" / f"{stage}.onnx").read_bytes()
    want = j_st3.convert_supertonic3(root / "jax", J_ST3)
    got = p_st3.convert_supertonic3(root / "jax", P_ST3)
    assert_same_tree(want, got)
    assert_same_tree(truth_p, got)  # the matcher recovers the written weights
    modules = {"text_encoder": p_st3_model.Supertonic3TextEncoder,
               "duration_predictor": p_st3_model.Supertonic3DurationPredictor,
               "vector_estimator": p_st3_model.Supertonic3VectorEstimator,
               "vocoder": p_st3_model.Supertonic3Vocoder}
    for stage, cls in modules.items():
        assert load_every_key(cls(P_ST3), got[stage], tmp_path / f"{stage}.npz")


def test_supertonic3_mismatch_raises_jax_s_errors(st3_release):
    root = st3_release[0]
    graph = p_onnx_reader.read_onnx_graph(root / "jax" / "text_encoder.onnx")
    for mutate in (lambda s: [dataclasses.replace(s[3], shape=(999,)) if i == 3 else x
                              for i, x in enumerate(s)],
                   lambda s: s[:5]):
        with pytest.raises(j_st3.ConversionError) as want:
            j_st3.match_stage(j_onnx_reader.read_onnx_graph(root / "jax" / "text_encoder.onnx"),
                              mutate(j_st3.SLOT_BUILDERS["text_encoder"](J_ST3)), "text_encoder")
        with pytest.raises(p_st3.ConversionError) as got:
            p_st3.match_stage(graph, mutate(p_st3.SLOT_BUILDERS["text_encoder"](P_ST3)),
                              "text_encoder")
        assert str(got.value) == str(want.value)
    with pytest.raises(p_st3.ConversionError, match="missing ONNX"):
        p_st3.convert_supertonic3(root / "nowhere", P_ST3)


def test_supertonic3_inventory_equals_jax(st3_release):
    root = st3_release[0]
    assert p_st3.inventory(root / "jax") == j_st3.inventory(root / "jax")


def test_supertonic_manager_converts_a_staged_release_in_place_as_jax_does(st3_release, tmp_path):
    """A staged ONNX release with no npz: each manager converts it in place
    and saves the npz beside it (the same files), then synthesizes the
    release's weights; the port's audio is JAX's within REL_L2_AUDIO."""
    root = st3_release[0]
    for who in ("jax", "port"):
        shutil.copytree(root / "jax", tmp_path / who)
        assert not list((tmp_path / who).glob("*.npz"))
    jm = j_st3_mgr.Supertonic3Manager(J_ST3, checkpoint_dir=tmp_path / "jax")
    pm = p_st3_mgr.Supertonic3Manager(P_ST3, checkpoint_dir=tmp_path / "port", device="cpu")
    for stage in p_st3.STAGES:
        assert_same_npz(tmp_path / "jax" / f"{stage}.npz", tmp_path / "port" / f"{stage}.npz")
    vocoder = p_st3_model.Supertonic3Vocoder(P_ST3)
    load_state(vocoder, load_npz(tmp_path / "port" / "vocoder.npz"))
    for key, value in pm.vocoder.state_dict().items():  # the release's weights, not seeded ones
        np.testing.assert_array_equal(value.numpy(), vocoder.state_dict()[key].numpy(), err_msg=key)
    want = jm.synthesize("Hello there.", "F1", "en", seed=5)
    got = pm.synthesize("Hello there.", "F1", "en", seed=5)
    assert got.duration == pytest.approx(want.duration, rel=1e-6)
    assert got.samples.shape == want.samples.shape
    assert _rel(got.samples, want.samples) <= REL_L2_AUDIO


def test_supertonic_manager_keeps_existing_npz(st3_release, tmp_path):
    """With the npz already there the release is not converted again."""
    root = st3_release[0]
    shutil.copytree(root / "jax", tmp_path / "r")
    p_st3_mgr.Supertonic3Manager(P_ST3, checkpoint_dir=tmp_path / "r", device="cpu")
    stamps = {p.name: p.stat().st_mtime_ns for p in (tmp_path / "r").glob("*.npz")}
    assert len(stamps) == 4
    p_st3_mgr.Supertonic3Manager(P_ST3, checkpoint_dir=tmp_path / "r", device="cpu")
    assert {p.name: p.stat().st_mtime_ns for p in (tmp_path / "r").glob("*.npz")} == stamps

