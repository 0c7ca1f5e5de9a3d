"""BENCHMARK.json and the files it names: names, units, and one file for
every configuration, cell, mix, driver and metric."""

import ast
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"][1] == "benchmark/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group == "configs", group == "workloads", entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("config", "traffic"):
                if key in entry:
                    assert NAME.match(entry[key])
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text]
    assert len(set(names)) == len(names)


def test_every_name_has_its_file(bench):
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
    for w in bench["workloads"]:
        assert w["chips"] == 1
        cell = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert (BENCH / "drivers" / f"{cell['driver']}.py").exists()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert cell["limits"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert e2e == {"diar_rtfx", "peak_mem_gib", "setup_s"}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        per = [m for m in bench["per_layer"] if w["name"] in m["workloads"]]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per


FORBIDDEN_IMPORTS = {"jax", "jaxlib", "flax", "optax", "fluidaudio_tpu", "fluidaudio_tpu_torch"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py"))
                         + sorted((BENCH / "yardstick").glob("*.py")), ids=lambda p: p.name)
def test_reference_and_yardstick_import_no_program(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            tops = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not FORBIDDEN_IMPORTS & set(tops), f"{path.name} imports {tops}"


def test_guard_compares_whole_top_level_names():
    from yardstick.guard import forbidden_modules

    ok = {"fluidaudio_tpu_torch": 1, "fluidaudio_tpu_torch.asr.manager": 1, "jaxtyping": 1,
          "flaxen": 1, "torch": 1}
    assert forbidden_modules(ok) == []
    bad = dict(ok, **{"fluidaudio_tpu.asr": 1, "jax.numpy": 1, "optax": 1})
    assert forbidden_modules(bad) == ["fluidaudio_tpu.asr", "jax.numpy", "optax"]
