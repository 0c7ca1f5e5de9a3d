"""Streaming variant catalog and factory of the PyTorch port against JAX.

The catalog (`STREAMING_VARIANTS`) equals JAX's key by key, with the port's
copy of `registry/model_names.py::Repo`; the catalog cases of
`tests/test_streaming_variants.py` run against the port (`jax_cases`); and
`create_streaming_manager` builds each family's port engine on the CPU at
tiny size, passing `device=` and the other keywords through.
"""

import dataclasses

import numpy as np
import pytest

from fluidaudio_tpu.asr.streaming_variants import STREAMING_VARIANTS as JAX_VARIANTS
from fluidaudio_tpu.registry.model_names import Repo as JaxRepo
from fluidaudio_tpu_torch.asr.multistream import MultiStreamMixin
from fluidaudio_tpu_torch.asr.streaming_eou import EOU_TEST, StreamingEouAsrManager
from fluidaudio_tpu_torch.asr.streaming_nemotron import NEMOTRON_TEST, StreamingNemotronAsrManager
from fluidaudio_tpu_torch.asr.streaming_variants import (
    STREAMING_VARIANTS,
    StreamingVariant,
    create_streaming_manager,
)
from fluidaudio_tpu_torch.asr.unified import StreamingUnifiedAsrManager, UnifiedAsrManager
from fluidaudio_tpu_torch.models.zoo import AsrModels
from fluidaudio_tpu_torch.registry import FAMILIES, Repo, required_models
from fluidaudio_tpu_torch.registry import model_names as port_names
from fluidaudio_tpu.registry import model_names as jax_names
from tests.test_torch_custom_vocab import jax_cases, one_torch_thread  # noqa: F401


def test_catalog_equals_jax_key_by_key():
    assert list(STREAMING_VARIANTS) == list(JAX_VARIANTS)
    for key, v in STREAMING_VARIANTS.items():
        w = JAX_VARIANTS[key]
        fields = dataclasses.asdict(v)
        want = dataclasses.asdict(w)
        assert fields.pop("repo").name == want.pop("repo").name
        assert fields == want
        assert dataclasses.asdict(v.repo.value) == dataclasses.asdict(w.repo.value)


def test_registry_names_equal_jax():
    assert [r.name for r in Repo] == [r.name for r in JaxRepo]
    assert all(dataclasses.asdict(Repo[r.name].value) == dataclasses.asdict(r.value)
               for r in JaxRepo)
    assert {k: (label, [r.name for r in repos]) for k, (label, repos) in FAMILIES.items()} == {
        k: (label, [r.name for r in repos]) for k, (label, repos) in jax_names.FAMILIES.items()}
    for repo in Repo:
        assert required_models(repo) == jax_names.required_models(JaxRepo[repo.name])
    assert port_names.TDT_PARTS == jax_names.TDT_PARTS


CASES = jax_cases("test_streaming_variants.py",
                  modules=("asr.streaming_variants", "registry.model_names"),
                  select=("test_all", "test_raw", "test_engine", "test_eou", "test_nemotron",
                          "test_unified", "test_repos", "test_unknown"))


@pytest.mark.parametrize("case", CASES)
def test_jax_catalog_case_on_the_port(case):
    case()


@pytest.fixture(scope="module")
def tiny_models():
    return AsrModels.load("test-tiny", device="cpu")


TINY_KWARGS = {
    "eou": lambda models: dict(spec=EOU_TEST, device="cpu"),
    "nemotron": lambda models: dict(spec=NEMOTRON_TEST, enc_cfg=EOU_TEST.enc_cfg, device="cpu"),
    "unified": lambda models: dict(models=models, device="cpu"),
    "unified-offline": lambda models: dict(models=models, device="cpu"),
}
ENGINES = {"eou": StreamingEouAsrManager, "nemotron": StreamingNemotronAsrManager,
           "unified": StreamingUnifiedAsrManager, "unified-offline": UnifiedAsrManager}


@pytest.mark.parametrize("key", list(STREAMING_VARIANTS))
def test_factory_builds_the_port_engine(key, tiny_models):
    v = STREAMING_VARIANTS[key]
    m = create_streaming_manager(key, **TINY_KWARGS[v.family](tiny_models))
    assert isinstance(m, ENGINES[v.family])
    if isinstance(m, MultiStreamMixin):
        assert m.chunk_ms == v.chunk_ms and m.device.type == "cpu"
    elif v.family == "unified":
        cfg = m._sliding.config
        assert (cfg.chunk_seconds, cfg.right_context_seconds) == (
            v.chunk_seconds, v.right_context_seconds)


def test_factory_engine_runs_and_accepts_variant_object(tiny_models):
    v = StreamingVariant("custom", "Custom", "eou", Repo.PARAKEET_EOU, chunk_ms=320)
    m = create_streaming_manager(v, spec=EOU_TEST, device="cpu")
    state = m.make_state()
    m.process(np.zeros(16_000, np.float32), state)
    assert m.finish(state).is_final
