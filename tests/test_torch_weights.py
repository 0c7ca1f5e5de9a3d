"""npz weight loading of the PyTorch port, and its independence from JAX.

Every key of the trained `test-tiny` checkpoints and of the streaming `eou`
and `nemotron` fixtures (encoder, predictor, joint) is consumed by the port's
modules, each lands in the torch layout, and a missing, extra or mis-shaped
key raises. The port's package must import no JAX.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fluidaudio_tpu.train.fixtures import trained_assets_dir
from fluidaudio_tpu_torch.asr.streaming_eou import EOU_TEST
from fluidaudio_tpu_torch.asr.streaming_nemotron import _PromptedEncoder
from fluidaudio_tpu_torch.models.conformer import ConformerEncoder
from fluidaudio_tpu_torch.models.conformer_streaming import StreamingConformerEncoder
from fluidaudio_tpu_torch.models.predictor import PredictorConfig, RnntJoint, RnntPredictor
from fluidaudio_tpu_torch.models.zoo import ASR_VERSIONS
from fluidaudio_tpu_torch.utils import weights

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
ALL_PARTS = {**PARTS, **STREAMING_PARTS}  # test-tiny parts are under asr/


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
    code = ("import sys, fluidaudio_tpu_torch.asr.manager, fluidaudio_tpu_torch.train.tiny_corpus,"
            " fluidaudio_tpu_torch.asr.streaming_nemotron, fluidaudio_tpu_torch.native.flac;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'jaxlib', 'fluidaudio_tpu')]; print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=PORT_DIR.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
