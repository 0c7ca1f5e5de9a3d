"""npz weight loading of the PyTorch port, and its independence from JAX.

Every key of the trained `test-tiny` checkpoints, of the streaming `eou`
and `nemotron` fixtures (encoder, predictor, joint) and of the `sensevoice`,
`paraformer`, `cohere`, `vad`, `offline` (segmentation, embedding) and
`sortformer` fixtures is consumed by the port's modules, each lands in the
torch layout, and a missing, extra or mis-shaped key raises. The flax
DenseGeneral attention kernels map by their own rule, and a 3-D Conv1d
kernel beside them keeps the Conv1d layout. The port's package must import no JAX.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fluidaudio_tpu.train.fixtures import trained_assets_dir
from fluidaudio_tpu_torch.asr.streaming_eou import EOU_TEST
from fluidaudio_tpu_torch.asr.streaming_nemotron import _PromptedEncoder
from fluidaudio_tpu_torch.models.cohere_asr import CohereDecoderStep, CohereEncoder
from fluidaudio_tpu_torch.models.conformer import ConformerEncoder
from fluidaudio_tpu_torch.models.conformer_streaming import StreamingConformerEncoder
from fluidaudio_tpu_torch.models.paraformer import PARAFORMER_TEST, Paraformer
from fluidaudio_tpu_torch.models.pyannote_seg import PyannoteSegmentation
from fluidaudio_tpu_torch.models.sortformer import SORTFORMER_TEST, SortformerModel
from fluidaudio_tpu_torch.models.wespeaker import WeSpeakerEmbedder
from fluidaudio_tpu_torch.models.predictor import PredictorConfig, RnntJoint, RnntPredictor
from fluidaudio_tpu_torch.models.sensevoice import SENSEVOICE_TEST, SenseVoiceEncoder
from fluidaudio_tpu_torch.models.silero_vad import SileroVadV5
from fluidaudio_tpu_torch.train.fixtures import cohere_tiny_config, offline_tiny_configs
from fluidaudio_tpu_torch.models.zoo import ASR_VERSIONS
from fluidaudio_tpu_torch.utils import weights
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

PORT_DIR = Path(weights.__file__).resolve().parents[1]
SPEC = ASR_VERSIONS["test-tiny"]
PARTS = {
    "encoder": lambda: ConformerEncoder(SPEC.conformer),
    "predictor": lambda: RnntPredictor(SPEC.predictor),
    "joint": lambda: RnntJoint(SPEC.predictor),
}
# the streaming fixtures: EOU_TEST (blank 18) and NEMOTRON_TEST (vocab 34,
# 4 prompts, the encoder under `encoder/` beside `prompt_embed`)
_RNNT = dict(n_layers=1, enc_hidden=64, pred_hidden=64, joint_hidden=64, n_durations=0)
_EOU_PRED = PredictorConfig(vocab_size=EOU_TEST.blank_id, **_RNNT)
_NEM_PRED = PredictorConfig(vocab_size=34, **_RNNT)
STREAMING_PARTS = {
    "eou/encoder": lambda: StreamingConformerEncoder(EOU_TEST.enc_cfg),
    "eou/predictor": lambda: RnntPredictor(_EOU_PRED),
    "eou/joint": lambda: RnntJoint(_EOU_PRED),
    "nemotron/encoder": lambda: _PromptedEncoder(EOU_TEST.enc_cfg, 4),
    "nemotron/predictor": lambda: RnntPredictor(_NEM_PRED),
    "nemotron/joint": lambda: RnntJoint(_NEM_PRED),
}
# the SenseVoice, Paraformer, Cohere and Silero fixtures: flax depthwise
# [K, 1, D] and plain [K, in, out] conv kernels (the 258-filter STFT basis
# [256, 1, 258] among them), the free `embed` and `pos_embed` tables, and
# Cohere's tied `embed.embedding`
FAMILY_PARTS = {
    "sensevoice/encoder": lambda: SenseVoiceEncoder(SENSEVOICE_TEST),
    "paraformer/model": lambda: Paraformer(PARAFORMER_TEST),
    "cohere/encoder": lambda: CohereEncoder(cohere_tiny_config()),
    "cohere/decoder": lambda: CohereDecoderStep(cohere_tiny_config()),
    "vad/silero_vad": lambda: SileroVadV5(),
    # the diarizers: flax DenseGeneral attention (`att0/query/kernel`
    # [d, H, Dh], `att0/out/kernel` [H, Dh, d]) beside the [251, 1, C] stem
    # conv, the NHWC ResNet trunk, and Sortformer's encoder + transformer
    "offline/segmentation": lambda: PyannoteSegmentation(offline_tiny_configs()[0]),
    "offline/embedding": lambda: WeSpeakerEmbedder(offline_tiny_configs()[1]),
    "sortformer/encoder": lambda: SortformerModel(SORTFORMER_TEST),
}
ALL_PARTS = {**PARTS, **STREAMING_PARTS, **FAMILY_PARTS}  # test-tiny parts are under asr/


@pytest.mark.parametrize("part", sorted(ALL_PARTS))
def test_trained_npz_keys_are_all_consumed(part):
    path = trained_assets_dir() / f"{part if '/' in part else 'asr/' + part}.npz"
    module = ALL_PARTS[part]()
    state = weights.load_npz(path)
    with np.load(path) as data:
        n_keys = len(data.files)
        raw = {k: data[k] for k in data.files}
    assert len(state) == n_keys == len(module.state_dict())
    weights.load_state(module, state)  # raises on any missing/extra/mis-shaped key
    own = module.state_dict()
    for key, arr in raw.items():
        torch_key, value = weights._torch_key_and_value(key, arr)
        np.testing.assert_array_equal(own[torch_key].numpy(), value, err_msg=key)


def test_layouts_of_dense_conv_and_kept_leaves():
    rs = np.random.RandomState(0)
    tree = {"params": {
        "fc": {"kernel": rs.randn(3, 5), "bias": rs.randn(5)},
        "dw": {"kernel": rs.randn(9, 1, 4)},             # Conv1d [k, in/g, out]
        "stem": {"kernel": rs.randn(3, 2, 1, 6)},        # Conv2d [kh, kw, in/g, out]
        "ln": {"scale": rs.randn(4), "bias": rs.randn(4)},
        "conv": {"bn_scale": rs.randn(4), "bn_bias": rs.randn(4)},
        "mhsa": {"pos_bias_u": rs.randn(2, 8), "pos_bias_v": rs.randn(2, 8)},
        "embedding": rs.randn(7, 4),
    }}
    state = weights.from_jax_params(tree)
    p = tree["params"]
    np.testing.assert_array_equal(state["fc.weight"], p["fc"]["kernel"].T)
    np.testing.assert_array_equal(state["fc.bias"], p["fc"]["bias"])
    assert state["dw.weight"].shape == (4, 1, 9)
    np.testing.assert_array_equal(state["dw.weight"][2, 0, 7], p["dw"]["kernel"][7, 0, 2])
    assert state["stem.weight"].shape == (6, 1, 3, 2)
    np.testing.assert_array_equal(state["stem.weight"][5, 0, 2, 1],
                                  p["stem"]["kernel"][2, 1, 0, 5])
    np.testing.assert_array_equal(state["ln.weight"], p["ln"]["scale"])
    for key in ("conv.bn_scale", "conv.bn_bias", "mhsa.pos_bias_u", "mhsa.pos_bias_v",
                "embedding"):
        a, b = key.split(".") if "." in key else (None, key)
        np.testing.assert_array_equal(state[key], p[a][b] if a else p[b])
    # the same tree given flat with '/'-joined keys maps identically
    flat = weights.flatten_tree(tree)
    assert set(weights.from_jax_params(flat)) == set(state)


def test_dense_general_attention_layout():
    """flax DenseGeneral q/k/v `kernel [d, H, Dh]` -> torch Linear `weight
    [H*Dh, d]` (bias [H, Dh] -> [H*Dh]), and `out` `kernel [H, Dh, d]` ->
    `weight [d, H*Dh]`: a Linear with them computes the flax einsums."""
    rs = np.random.RandomState(1)
    d, H, Dh = 6, 2, 3
    tree = {"params": {"att": {
        "query": {"kernel": rs.randn(d, H, Dh), "bias": rs.randn(H, Dh)},
        "out": {"kernel": rs.randn(H, Dh, d), "bias": rs.randn(d)},
    }}}
    state = weights.from_jax_params(tree)
    p = tree["params"]["att"]
    assert state["att.query.weight"].shape == (H * Dh, d)
    assert state["att.query.bias"].shape == (H * Dh,)
    assert state["att.out.weight"].shape == (d, H * Dh)
    x = rs.randn(4, d)
    want_q = np.einsum("nd,dhk->nhk", x, p["query"]["kernel"]) + p["query"]["bias"]
    got_q = x @ state["att.query.weight"].T + state["att.query.bias"]
    np.testing.assert_allclose(got_q, want_q.reshape(4, H * Dh), rtol=1e-12)
    a = rs.randn(4, H, Dh)
    want_o = np.einsum("nhk,hkd->nd", a, p["out"]["kernel"]) + p["out"]["bias"]
    got_o = a.reshape(4, H * Dh) @ state["att.out.weight"].T + state["att.out.bias"]
    np.testing.assert_allclose(got_o, want_o, rtol=1e-12)


def test_conv1d_kernel_keeps_its_layout_beside_dense_general():
    """A 3-D kernel under any other name (the segmentation stem [251, 1, C],
    a conv named like a Dense elsewhere) still maps as a Conv1d,
    [k, in, out] -> [out, in, k], even when its shape would fit the
    DenseGeneral reshape."""
    rs = np.random.RandomState(2)
    tree = {"params": {
        "stem": {"kernel": rs.randn(251, 1, 16)},
        "conv0": {"kernel": rs.randn(5, 4, 8)},
        "proj": {"kernel": rs.randn(8, 2, 4)},
    }}
    state = weights.from_jax_params(tree)
    p = tree["params"]
    for name in ("stem", "conv0", "proj"):
        np.testing.assert_array_equal(state[f"{name}.weight"],
                                      p[name]["kernel"].transpose(2, 1, 0))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_bad_checkpoint_raises(fault):
    module = RnntJoint(SPEC.predictor)
    state = weights.load_npz(trained_assets_dir() / "asr" / "joint.npz")
    if fault == "missing":
        del state["out.bias"]
    elif fault == "extra":
        state["surplus.weight"] = np.zeros((2, 2), np.float32)
    else:
        state["out.weight"] = state["out.weight"].T.copy()
    with pytest.raises(ValueError, match="mismatch"):
        weights.load_state(module, state)


def test_unsupported_kernel_rank_raises():
    with pytest.raises(ValueError, match="rank"):
        weights.from_jax_params({"params": {"x": {"kernel": np.zeros((1, 1, 1, 1, 1))}}})


def test_port_sources_never_import_jax():
    for path in [*PORT_DIR.rglob("*.py"), PORT_DIR.parent / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                mod = words[1].split(".")[0].rstrip(",")
                assert mod not in ("jax", "flax", "jaxlib", "fluidaudio_tpu"), (path, line)


def test_importing_the_port_leaves_no_jax_in_sys_modules():
    # every module of the port, imported
    code = ("import importlib, pkgutil, sys, fluidaudio_tpu_torch as p;"
            "[importlib.import_module(m.name) for m in "
            "pkgutil.walk_packages(p.__path__, 'fluidaudio_tpu_torch.')];"
            "assert all(m in sys.modules for m in ("
            "'fluidaudio_tpu_torch.asr.keyword_spotter',"
            "'fluidaudio_tpu_torch.registry.doctor', 'fluidaudio_tpu_torch.registry.datasets',"
            "'fluidaudio_tpu_torch.asr.sensevoice_manager',"
            "'fluidaudio_tpu_torch.asr.paraformer_manager',"
            "'fluidaudio_tpu_torch.asr.cohere_manager', 'fluidaudio_tpu_torch.vad.manager',"
            "'fluidaudio_tpu_torch.vad.segmentation', 'fluidaudio_tpu_torch.models.silero_vad',"
            "'fluidaudio_tpu_torch.diarizer.sortformer', 'fluidaudio_tpu_torch.diarizer.offline.vbx',"
            "'fluidaudio_tpu_torch.native.fastcluster'));"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'jaxlib', 'fluidaudio_tpu')]; print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=PORT_DIR.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
