"""Custom vocabulary of the PyTorch port (`asr/custom_vocab/`) against JAX.

The port's `bktree`, `context`, `ctc_spotter` and `rescorer` are copies of
the JAX package's (they import no JAX). Every case of
`tests/test_custom_vocab.py` runs here against the port's modules: the JAX
test module's source is loaded with its `fluidaudio_tpu.` imports pointed
at `fluidaudio_tpu_torch.` (`jax_cases`, shared with the other port test
files), so each case asserts the same outputs of the port. Then the CTC
keyword DP, `spot_keywords` and `ctc_token_rescore` are held against the
JAX functions on the same seeded inputs.
"""

from __future__ import annotations

import ctypes
import inspect
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidaudio_tpu.asr.custom_vocab import context as jax_context
from fluidaudio_tpu.asr.custom_vocab import ctc_spotter as jax_spotter
from fluidaudio_tpu.asr.custom_vocab import rescorer as jax_rescorer
from fluidaudio_tpu.asr.tokenizer import Tokenizer as JaxTokenizer
from fluidaudio_tpu.train.fixtures import trained_assets_dir
from fluidaudio_tpu_torch.asr.custom_vocab import context as port_context
from fluidaudio_tpu_torch.asr.custom_vocab import ctc_spotter as port_spotter
from fluidaudio_tpu_torch.asr.custom_vocab import rescorer as port_rescorer
from fluidaudio_tpu_torch.asr.tokenizer import Tokenizer as PortTokenizer


_MODULES: dict = {}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a port test module's torch ops on one intra-op thread, restoring
    the count after it. pytest-xdist runs several workers on the same cores
    (`-n 6 --dist loadfile` keeps a file on one worker); torch's default of
    one OpenMP thread per core then oversubscribes the machine and a batch
    that takes tens of ms alone takes seconds. Every `tests/test_torch_*.py`
    file imports this fixture, which applies it to all of its tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class PortNativeLibrary:
    """The port's native libraries behind the JAX loader's one-library
    interface (`fluidaudio_tpu.native.load_native` returns one CDLL with every
    symbol): a symbol resolves in the port's library that its prefix names,
    built from the same `native/` source by `native/cxx.py` at first use.
    `hasattr` on a symbol no library has is False, as on a CDLL."""

    def __init__(self):
        from fluidaudio_tpu_torch.native import fastcluster, flac, itn, sysinfo

        self._by_prefix = (("flac_", flac), ("fastcluster_", fastcluster), ("nemo_", itn),
                           ("fluidaudio_", sysinfo))
        self._libs: dict = {}

    def __getattr__(self, name):
        for prefix, module in self._by_prefix:
            if name.startswith(prefix):
                if prefix not in self._libs:  # a CDLL of its own: JAX sets restype/argtypes
                    self._libs[prefix] = ctypes.CDLL(str(module.build_library()[0]))
                return getattr(self._libs[prefix], name)
        raise AttributeError(name)


@pytest.fixture(scope="module", autouse=True)
def jax_native_on_the_port_build():
    """Put `PortNativeLibrary` into the JAX loader's `_LIB`/`_SEARCHED` slot
    for a whole port test module, so that JAX code used as an oracle never
    starts the loader's cmake build (a build that several test workers would
    otherwise start at once in the same `native/build/`). A port test module
    whose JAX oracle reaches the JAX native loader imports this fixture."""
    from fluidaudio_tpu import native as jax_native

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB", PortNativeLibrary())
        mp.setattr(jax_native, "_SEARCHED", True)
        yield


def jax_module(test_file: str, modules=("",), overrides=None, edits=()) -> types.ModuleType:
    """The JAX package's test module `tests/<test_file>`, its source loaded
    with the imports of `modules` (dotted names under `fluidaudio_tpu`; ""
    means every one) pointed at the port's and each (old, new) of `edits`
    replaced (each must occur: e.g. `device="cpu"` added to a constructor
    call), then the names of `overrides` set in its namespace. Loaded once
    per arguments."""
    key = (test_file, tuple(modules), tuple((k, id(v)) for k, v in (overrides or {}).items()),
           tuple(edits))
    if key not in _MODULES:
        path = Path(__file__).with_name(test_file)
        src = path.read_text()
        for old, new in edits:
            assert old in src, (test_file, old)
            src = src.replace(old, new)
        for name in modules:
            pattern = r"\bfluidaudio_tpu\." + (re.escape(name) + r"\b" if name else "")
            src = re.sub(pattern, "fluidaudio_tpu_torch." + name, src)
        mod = types.ModuleType(f"ported_{path.stem}")
        mod.__file__ = str(path)
        exec(compile(src, str(path), "exec"), mod.__dict__)
        mod.__dict__.update(overrides or {})
        _MODULES[key] = mod
    return _MODULES[key]


def jax_fixtures(test_file: str, modules=("",), overrides=None, edits=()) -> dict:
    """The pytest fixtures the loaded module defines, by name: set them in a
    port test module's globals so that its `jax_cases` can request them
    (autouse ones then apply to every test of that module)."""
    mod = jax_module(test_file, modules, overrides, edits)
    return {name: obj for name, obj in vars(mod).items()
            if type(obj).__name__ == "FixtureFunctionDefinition"}


class _Case:
    """One JAX test case on the port; fixture arguments come from `request`,
    `bound` ones (a parametrize mark's values) are given."""

    def __init__(self, fn, fixtures, cls=None, bound=None):
        self.fn, self.fixtures, self.cls, self.bound = fn, fixtures, cls, bound or {}

    def __call__(self, request=None):
        kwargs = {name: request.getfixturevalue(name) for name in self.fixtures}
        kwargs.update(self.bound)
        if self.cls is not None:
            return getattr(self.cls(), self.fn.__name__)(**kwargs)
        return self.fn(**kwargs)


def _parametrized(fn) -> list[tuple[str, dict]]:
    """(id suffix, bound arguments) per combination of `fn`'s
    `pytest.mark.parametrize` marks; [("", {})] when it has none."""
    combos = [("", {})]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        names = [n.strip() for n in names.split(",")] if isinstance(names, str) else list(names)
        rows = []
        for i, v in enumerate(values):
            v = v.values if hasattr(v, "values") and hasattr(v, "marks") else v
            v = v if len(names) > 1 else (v,)
            rows.append((str(i), dict(zip(names, v))))
        combos = [(f"{a}-{b}".strip("-"), {**da, **db}) for a, da in combos for b, db in rows]
    return combos


def jax_cases(test_file: str, modules=("",), select=None, *, overrides=None, edits=(),
              fixtures=False, params=False) -> list:
    """The test functions and test-class methods of the JAX package's test
    module `tests/<test_file>` (loaded by `jax_module`), with `select` only
    those whose qualified name starts with one of its prefixes.
    -> pytest.param(case, id=qualified name) per case; `case(request)` runs
    it. Cases that take fixtures are kept only with `fixtures=True`: they
    request them through `request` (built-in ones, and the module's own
    once `jax_fixtures` are set in the caller's globals). With
    `params=True` a case with `pytest.mark.parametrize` marks becomes one
    case per value set (id `name[i]`), its arguments bound."""
    mod = jax_module(test_file, modules, overrides, edits)
    cases = []
    for name, obj in vars(mod).items():
        if name.startswith("test_") and inspect.isfunction(obj):
            members = [(name, obj, None)]
        elif name.startswith("Test") and inspect.isclass(obj):
            members = [(f"{name}.{m}", fn, obj) for m, fn in vars(obj).items()
                       if m.startswith("test_") and inspect.isfunction(fn)]
        else:
            continue
        for qualname, fn, cls in members:
            if select and not qualname.startswith(tuple(select)):
                continue
            for suffix, bound in (_parametrized(fn) if params else [("", {})]):
                needs = [p for p in inspect.signature(fn).parameters
                         if p != "self" and p not in bound]
                if needs and not fixtures:
                    continue
                cases.append(pytest.param(_Case(fn, needs, cls, bound),
                                          id=f"{qualname}[{suffix}]" if suffix else qualname))
    return cases


@pytest.mark.parametrize("case", jax_cases("test_custom_vocab.py"))
def test_jax_custom_vocab_case_on_the_port(case):
    case()


def _log_probs(seed: int, T: int = 60, V: int = 17) -> np.ndarray:
    rs = np.random.RandomState(seed)
    logits = rs.randn(T, V).astype(np.float32) * 3.0
    logits[:, V - 1] += 2.0  # blank-heavy, as a trained CTC head is
    return (logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keyword_dp_and_spots_equal_jax(seed):
    lp = _log_probs(seed)
    blank = lp.shape[1] - 1
    keywords = {"acme": [0, 1], "corp": [2, 3], "foo": [14, 15, 15], "the": [4]}
    for tokens in keywords.values():
        want = jax_spotter.ctc_keyword_dp(lp.astype(np.float64), tokens, blank)
        got = port_spotter.ctc_keyword_dp(lp.astype(np.float64), tokens, blank)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    for kw in (dict(), dict(temperature=1.5, blank_bias=-0.5, min_score=-6.0)):
        want = jax_spotter.spot_keywords(lp, keywords, blank, **kw)
        got = port_spotter.spot_keywords(lp, keywords, blank, **kw)
        assert [vars(s) for s in got] == [vars(s) for s in want]


def test_ctc_token_rescore_equals_jax():
    """The CTC-vs-CTC rescorer on the trained `ctc` fixture's vocabulary
    (w0..w15, blank 16) and seeded log-probs in which the hypothesis word
    w13 sits over frames that favour w12, and an alias decoy: the same text
    and replacements (with their scores), some of them taken."""
    rs = np.random.RandomState(7)
    logits = rs.randn(60, 17).astype(np.float32)
    logits[:, 16] += 3.0
    words = ["w5", "w13", "w8", "w1"]
    for i, w in enumerate(words):
        f0 = int(0.42 * i / 0.08) + 1
        if w == "w13":
            logits[f0:f0 + 2, 12] += 3.5
            logits[f0:f0 + 2, 13] += 3.0
        else:
            logits[f0:f0 + 2, int(w[1:])] += 6.0
    lp = (logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))).astype(np.float32)
    vocab_json = trained_assets_dir() / "ctc" / "vocab.json"

    def run(tok_cls, context_mod, rescorer_mod):
        tok = tok_cls.from_json(vocab_json)
        ctx = context_mod.CustomVocabularyContext(
            [context_mod.VocabularyTerm(text="w12", aliases=["w13"]),
             context_mod.VocabularyTerm(text="w0", aliases=["w8"])],
            tok, min_term_length=2)
        timings = [rescorer_mod.WordTiming(word=w, start_time=0.42 * i,
                                           end_time=0.42 * (i + 1))
                   for i, w in enumerate(words)]
        out = rescorer_mod.ctc_token_rescore(timings, lp, 0.08, ctx, tok, blank_id=16)
        return out.text, [vars(r) for r in out.replacements]

    got = run(PortTokenizer, port_context, port_rescorer)
    assert got == run(JaxTokenizer, jax_context, jax_rescorer)
    assert got[1]  # the case replaces something
