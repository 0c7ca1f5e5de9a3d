"""`parallel/` of the PyTorch port over an 8-process gloo group (4 x 2 mesh).

JAX's tests run 8 virtual CPU devices; the port runs 8 CPU processes, one
per "device" (`tests/torch_parallel_ranks.py`, spawned once for this
module, no JAX in them). Its cases are JAX's six `tests/test_multichip.py`
cases and the three mesh cases of `tests/test_multistream.py` on the
port, each held to JAX's assertions (`torch_parallel_ranks.expect_*`,
which also run on cards: `python tests/torch_parallel_ranks.py --check 4
cuda`); the sharded CTC and TDT losses and gradients against the
single-device ones (tolerances in `_expect_equal_to_single_device`); and
the port's `param_sharding_rules` against JAX's rule on the same
parameter trees, parameter by parameter through the key map
(`utils/weights.py`).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch.distributed as dist

from fluidaudio_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from fluidaudio_tpu.models.predictor import PredictorConfig as JaxPredictorConfig
from fluidaudio_tpu.parallel import mesh as jax_mesh
from fluidaudio_tpu.parallel import train as jax_train
from fluidaudio_tpu_torch.parallel.mesh import make_mesh
from fluidaudio_tpu_torch.utils.weights import _torch_key_and_value
from tests import torch_parallel_ranks as ranks
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

WORLD = 8


@pytest.fixture(scope="module")
def group_run(tmp_path_factory) -> dict:
    """The 8 ranks, spawned once; -> {case: {"ok", "out" | "error"}}."""
    try:
        return ranks.spawn(WORLD, "cpu", tmp_path_factory.mktemp("gloo"))
    except RuntimeError as e:
        pytest.fail(str(e))


@pytest.fixture(scope="module")
def cpu_mesh_1x1():
    """A 1 x 1 CPU mesh in this process (a one-rank gloo group that
    `make_mesh(1)` brings up itself), torn down after the module."""
    owned = not dist.is_initialized()
    mesh = make_mesh(1, device="cpu")
    yield mesh
    if owned:
        dist.destroy_process_group()


def _expect(group_run: dict, case: str) -> None:
    result = group_run[case]
    assert result["ok"], result["error"]
    ranks.EXPECT[case](result["out"])


# --------------------------------------------- JAX's test_multichip.py cases


def test_mesh_and_param_sharding(group_run):
    _expect(group_run, "mesh_and_param_sharding")


def test_dryrun_multichip_entrypoint(group_run):
    _expect(group_run, "dryrun_multichip")


def test_manager_sharded_long_file_matches_single_device(group_run):
    _expect(group_run, "manager_sharded_long_file_matches_single_device")


def test_vad_sharded_batch_matches_single_device(group_run):
    _expect(group_run, "vad_sharded_batch_matches_single_device")


def test_sortformer_sharded_offline_matches_single_device(group_run):
    _expect(group_run, "sortformer_sharded_offline_matches_single_device")


def test_manager_set_mesh_validates_batch_divisibility(group_run):
    _expect(group_run, "manager_set_mesh_validates_batch_divisibility")


# --------------------------------------- JAX's test_multistream.py mesh cases


def test_mesh_sharded_matches_single_stream(group_run):
    _expect(group_run, "mesh_sharded_matches_single_stream")


def test_mesh_requires_divisible_stream_count(group_run):
    _expect(group_run, "mesh_requires_divisible_stream_count")


def test_mesh_sharded_multilingual(group_run):
    _expect(group_run, "mesh_sharded_multilingual")


# ------------------------------------------- sharded steps vs single device


@pytest.mark.parametrize("kind", ["ctc", "tdt"])
def test_sharded_loss_and_grads_equal_single_device(group_run, kind):
    _expect(group_run, f"{kind}_loss_and_grads_equal_single_device")


# ---------------------------------------- the sharding rule against JAX's


def _torch_axis_of(flax_key: str, shape: tuple, axis: int | None) -> int | None:
    """The torch axis that holds flax axis `axis` of a parameter, found by
    carrying an array that counts along that axis through the key map."""
    if axis is None:
        return None
    marks = np.arange(shape[axis]).reshape([-1 if i == axis else 1 for i in range(len(shape))])
    _, value = _torch_key_and_value(flax_key, np.broadcast_to(marks, shape).copy())
    varying = [k for k in range(value.ndim) if np.any(np.diff(value, axis=k))]
    assert len(varying) == 1, (flax_key, shape, axis)
    return varying[0]


def _jax_rule_on_torch_names(params) -> dict:
    """JAX's `param_sharding_rules` on a 4 x 2 JAX mesh -> {torch name: the
    torch axis sharded over "model", or None}."""
    mesh = jax_mesh.make_mesh(8, data=4, model=2)
    shardings = jax_mesh.param_sharding_rules(mesh, params)
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    values = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    out = {}
    for path, sharding in flat:
        keys = [str(getattr(k, "key", k)) for k in path]
        top, rest = keys[0], keys[1:]
        flax_key = "/".join(rest) if rest else top
        shape = tuple(values[path].shape)
        spec = list(sharding.spec) + [None] * (len(shape) - len(sharding.spec))
        axis = spec.index("model") if "model" in spec else None
        torch_key, _ = _torch_key_and_value(flax_key, np.zeros(shape, np.float32))
        name = f"{top}.{torch_key}" if rest else top
        out[name] = _torch_axis_of(flax_key, shape, axis)
    return out


def test_param_sharding_rules_equal_jax(group_run):
    cfg = JaxConformerConfig(**ranks.DRYRUN)
    state, _, _ = jax_train.create_train_state(jax.random.PRNGKey(0), cfg, ranks.VOCAB,
                                               ranks.MEL_FRAMES)
    pcfg = JaxPredictorConfig(vocab_size=ranks.VOCAB, pred_hidden=32, n_layers=1,
                              enc_hidden=cfg.d_model, joint_hidden=32, n_durations=5)
    tstate, _, _ = jax_train.create_tdt_train_state(jax.random.PRNGKey(1), cfg, pcfg,
                                                    ranks.MEL_FRAMES)
    _expect(group_run, "param_sharding_rules_equal_jax")
    out = group_run["param_sharding_rules_equal_jax"]["out"]
    for kind, params in (("ctc", state.params), ("tdt", tstate.params)):
        want = _jax_rule_on_torch_names(params)
        assert out[kind] == want, kind


class _Stop(Exception):
    pass


def _stop(device):
    raise _Stop(device)


@pytest.mark.parametrize("device,local_rank,want", [(None, "1", [1]), (None, None, [3 % 2]),
                                                    ("cuda", "0", [0]), ("cuda:0", "1", [])],
                         ids=["LOCAL_RANK", "rank_mod_cards", "cuda", "index_given"])
def test_make_mesh_gives_each_rank_its_card(monkeypatch, device, local_rank, want):
    """With several ranks on cards (rank 3 of 4 here, 2 cards) `make_mesh`
    selects this rank's card before CUDA is touched: `LOCAL_RANK` when a
    launcher set it, else the rank modulo the cards; an explicit index is
    kept. The card machinery is replaced (this machine has none) and the
    call stopped right after the selection."""
    from fluidaudio_tpu_torch.parallel import mesh as port_mesh

    chosen = []
    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(port_mesh.dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(port_mesh.dist, "get_rank", lambda: 3)
    monkeypatch.setattr(port_mesh.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port_mesh.torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(port_mesh.torch.cuda, "set_device", chosen.append)
    monkeypatch.setattr(port_mesh, "resolve_device", _stop)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    with pytest.raises(_Stop):
        port_mesh.make_mesh(4, data=2, model=2, device=device)
    assert chosen == want
