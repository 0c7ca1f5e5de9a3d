"""Inverse text normalization of the PyTorch port against the JAX package.

The engine is the repo's `native/itn/itn.cpp`; the port builds it on its own
(`native/itn.py` through `native/cxx.py`, into `fluidaudio_tpu_torch/_build/`)
and binds it in `itn/normalizer.py`.

- Every ITN case of `tests/test_native.py` runs on the port (`jax_cases`,
  each parametrized value set a case): the English, multilingual, date /
  time / fraction / money and regression vectors with their expected
  strings, and the custom-rule surface. The class fixtures those cases take
  (`norm`, `tn`) are restated here over the port's `TextNormalizer`; the
  JAX module's `native_available()` probe, which would start the JAX
  loader's cmake build, is not run.
- `normalize` and `normalize_sentences` equal the JAX package's on every
  case string and on sentence runs built from them. The JAX wrapper runs
  over the engine built from the same source: its loader's library slot is
  set to the port's build for the test (and restored), so no cmake build
  into `native/build/` starts beside the JAX suite's own.
- A failed build raises; nothing passes text through.
"""

from __future__ import annotations

import ctypes
import shutil

import pytest

import fluidaudio_tpu.native as jax_native
from fluidaudio_tpu.itn.normalizer import TextNormalizer as JaxNormalizer
from fluidaudio_tpu_torch.itn import TextNormalizer
from fluidaudio_tpu_torch.native import itn as port_itn
from tests.test_torch_custom_vocab import _parametrized, jax_cases, jax_module
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

NATIVE_EDITS = (
    ("from fluidaudio_tpu.native import load_native\n"
     "from fluidaudio_tpu.native.fastcluster import centroid_linkage, cut_tree, native_available\n"
     "from fluidaudio_tpu.native.sysinfo import current_rss_bytes, peak_rss_bytes\n", ""),
    ('needs_native = pytest.mark.skipif(not native_available(), reason="native lib not built")',
     'needs_native = pytest.mark.skipif(False, reason="the port builds its library at first use")'),
)
_ITN = ("test_itn_english", "test_itn_passthrough_other_language", "TestItnMultilingual",
        "TestItnDatesTimesFractionsMoney", "TestItnReviewRegressions", "TestCustomRules")
CASES = jax_cases("test_native.py", ("itn",), _ITN, edits=NATIVE_EDITS, fixtures=True,
                  params=True)


@pytest.fixture(scope="module")
def norm():
    """`TestItnMultilingual.norm` / `TestItnDatesTimesFractionsMoney.norm`."""
    return TextNormalizer()


@pytest.fixture()
def tn():
    """`TestCustomRules.tn`: rules cleared before and after."""
    t = TextNormalizer("en")
    t.clear_rules()
    yield t
    t.clear_rules()


@pytest.mark.parametrize("case", CASES)
def test_jax_itn_case_on_the_port(case, request):
    case(request)


def _case_strings() -> list[tuple[str, str]]:
    """(language, spoken) of every parametrized ITN vector of test_native.py."""
    mod = jax_module("test_native.py", ("itn",), edits=NATIVE_EDITS)
    out = []
    for fn in (mod.test_itn_english, mod.TestItnMultilingual.test_normalize,
               mod.TestItnDatesTimesFractionsMoney.test_vectors,
               mod.TestItnDatesTimesFractionsMoney.test_ambiguity_gate):
        for _, bound in _parametrized(fn):
            out.append((bound.get("lang", "en"), bound.get("spoken") or bound["src"]))
    return out


@pytest.fixture()
def jax_over_the_same_engine(monkeypatch):
    """The JAX `TextNormalizer` over the engine built from the same source
    (the port's build), its loader state restored after the test."""
    monkeypatch.setattr(jax_native, "_LIB", ctypes.CDLL(str(port_itn.build_library()[0])))
    monkeypatch.setattr(jax_native, "_SEARCHED", True)
    return JaxNormalizer("en")


def test_normalize_and_sentences_equal_jax_on_every_case_string(jax_over_the_same_engine):
    jax_tn, port_tn = jax_over_the_same_engine, TextNormalizer("en")
    strings = _case_strings()
    assert len(strings) >= 60
    for lang, text in strings:
        assert port_tn.normalize(text, lang) == jax_tn.normalize(text, lang), (lang, text)
    for lang in sorted({lang for lang, _ in strings}):
        run = ". ".join(t for lg, t in strings if lg == lang) + "."
        assert port_tn.normalize_sentences(run, lang) == jax_tn.normalize_sentences(run, lang)
    assert port_tn.version == jax_tn.version and port_tn.supports("de") == jax_tn.supports("de")


def test_cases_cover_the_itn_suites():
    # the case count pytest collects from those tests of test_native.py
    assert len(CASES) == 10 + 1 + (26 + 2) + (26 + 3) + 5 + 10
    assert all(c.id.startswith(_ITN) for c in CASES)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile: RuntimeError, no passthrough."""
    bad = tmp_path / "itn.cpp"
    bad.write_text(port_itn.SOURCE.read_text() + "\nthis is not C++;\n")
    shutil.copy(port_itn.SOURCE.with_suffix(".h"), tmp_path / "itn.h")
    monkeypatch.setattr(port_itn, "SOURCE", bad)
    port_itn.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="itn build failed"):
            TextNormalizer("en")
    finally:
        port_itn.load_library.cache_clear()


def test_the_library_lives_in_the_port_build_dir():
    lib, _ = port_itn.build_library()
    assert lib.parent.name == "_build" and lib.parent.parent.name == "fluidaudio_tpu_torch"
    assert lib.name.startswith("libitn_") and TextNormalizer().is_native_available
