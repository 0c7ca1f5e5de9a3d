"""The CLI of the PyTorch port (`python -m fluidaudio_tpu_torch.cli`) against
the JAX package's CLI, on the CPU at test widths.

- Every case of `tests/test_cli_benchmarks.py` and `tests/test_cli_families.py`,
  the CLI cases of `tests/test_datasets.py` and of
  `tests/test_multilingual_scoring.py` run on the port (`jax_cases`, their
  `fluidaudio_tpu.` imports pointed at the port, so that their monkeypatches
  land on the port's modules), with one edit to each call: `main([` becomes
  `main(["--device", "cpu", `. The cases that build a tiny Nemotron import
  `TINY_EN`/`TINY_ENC`/`TINY_MULTI` from here (the port's loading of
  `tests/test_nemotron.py`) instead of from the JAX test module.
- Every subcommand JAX registers is registered in the port with the same
  arguments and defaults.
- Without a card and without `--device cpu` a command exits 1 naming
  `--device cpu`; `python -m` exits with the command's return code.
- On the trained fixtures the port's `synthetic-guardrail` prints JAX's keys
  and gate numbers, and `transcribe`, `vad-analyze` and
  `diarize --mode sortformer --rttm` print what JAX's CLI prints.
- `benchmark` prints JAX's four metric lines; `streaming-latency-benchmark`
  counts the tokens `process` emits over the same chunks.
"""

import argparse
import importlib
import json
import os
import subprocess
import sys
import wave
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from fluidaudio_tpu.cli.main import main as jax_main
from fluidaudio_tpu_torch.cli.main import main
from fluidaudio_tpu_torch.train import fixtures as fx
from fluidaudio_tpu_torch.train import tiny_corpus as tc
from tests.test_torch_custom_vocab import (  # noqa: F401
    jax_cases,
    jax_fixtures,
    jax_module,
    one_torch_thread,
)

REPO = Path(__file__).resolve().parents[1]
MAIN_EDIT = ("main([", 'main(["--device", "cpu", ')
NEMOTRON_EDIT = ("from tests.test_nemotron import", "from tests.test_torch_cli import")
# the JAX tests' stand-in managers take the `device=` each command passes
NEMOTRON_DEVICE_EDIT = ("chunk_ms=560, enc_cfg=TINY_ENC",
                        "chunk_ms=560, enc_cfg=TINY_ENC, device=args.device")
FAMILIES_DEVICE_EDITS = (
    ("lambda: real(SENSEVOICE_TEST)", "lambda **kw: real(SENSEVOICE_TEST, **kw)"),
    ("lambda: real(SORTFORMER_TEST)", "lambda **kw: real(SORTFORMER_TEST, **kw)"),
    ('lambda step_ms=500, variant="dih3": real(LSEEND_TEST, step_ms=step_ms)',
     'lambda step_ms=500, variant="dih3", **kw: real(LSEEND_TEST, step_ms=step_ms, **kw)'),
    NEMOTRON_DEVICE_EDIT)
FAMILIES_EDITS = (MAIN_EDIT, NEMOTRON_EDIT) + FAMILIES_DEVICE_EDITS
SCORING_EDITS = (MAIN_EDIT, NEMOTRON_EDIT, NEMOTRON_DEVICE_EDIT)

# the tiny Nemotron specs of tests/test_nemotron.py, built from the port's classes
_TINY = jax_module("test_nemotron.py")
TINY_EN, TINY_ENC, TINY_MULTI = _TINY.TINY_EN, _TINY.TINY_ENC, _TINY.TINY_MULTI

_DATASET_CLI = ("test_vad_benchmark_cli", "test_sortformer_benchmark_cli",
                "test_ctc_earnings_benchmark_cli", "test_download_dataset_cli_offline")
for _file, _edits in (("test_cli_benchmarks.py", (MAIN_EDIT,)),
                      ("test_cli_families.py", FAMILIES_EDITS),
                      ("test_datasets.py", (MAIN_EDIT,)),
                      ("test_multilingual_scoring.py", SCORING_EDITS)):
    globals().update(jax_fixtures(_file, edits=_edits))

CASES = (jax_cases("test_cli_benchmarks.py", edits=(MAIN_EDIT,), fixtures=True)
         + jax_cases("test_cli_families.py", edits=FAMILIES_EDITS, fixtures=True,
                     params=True)
         + jax_cases("test_datasets.py", select=_DATASET_CLI, edits=(MAIN_EDIT,), fixtures=True)
         + jax_cases("test_multilingual_scoring.py", select=("TestCliHarness",),
                     edits=SCORING_EDITS, fixtures=True))


def test_every_jax_cli_case_is_collected():
    # 7 + (7 + 17 registered commands) + 4 + 3
    assert len(CASES) == 38


@pytest.mark.parametrize("case", CASES)
def test_jax_cli_case_on_the_port(case, request):
    case(request)


# ------------------------------------------------------------- registration


class _Parsed(Exception):
    pass


def _subcommands(main_fn) -> dict[str, argparse.ArgumentParser]:
    """The subparsers `main_fn` registers, by name (captured at parse time)."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture):
        with pytest.raises(_Parsed):
            main_fn([])
    sub = next(a for a in seen["parser"]._actions if isinstance(a, argparse._SubParsersAction))
    return dict(sub.choices)


def _arguments(parser: argparse.ArgumentParser) -> list[tuple]:
    return [(tuple(a.option_strings), a.dest, a.default, a.nargs, a.const,
             tuple(a.choices) if a.choices else None, a.required,
             getattr(a.type, "__name__", a.type))
            for a in parser._actions if not isinstance(a, argparse._HelpAction)]


JAX_COMMANDS = _subcommands(jax_main)
PORT_COMMANDS = _subcommands(main)


def test_forty_subcommands():
    assert len(JAX_COMMANDS) == 40 and set(PORT_COMMANDS) == set(JAX_COMMANDS)


@pytest.mark.parametrize("command", sorted(JAX_COMMANDS))
def test_subcommand_registered_with_jax_arguments(command):
    assert command in PORT_COMMANDS
    assert _arguments(PORT_COMMANDS[command]) == _arguments(JAX_COMMANDS[command])


# ------------------------------------------------------------------ device


def test_without_a_card_a_command_exits_nonzero_naming_device_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["normalize", "twenty", "one"]) == 1
    err = capsys.readouterr().err
    assert "--device cpu" in err and "no CUDA device" in err


def test_python_m_exits_with_the_commands_code():
    """JAX's `__main__` drops `main()`'s return value; the port's passes it
    to `sys.exit`: 2 for unknown guardrail families, 1 without a card."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(REPO)}
    cmd = [sys.executable, "-m", "fluidaudio_tpu_torch.cli"]
    run = subprocess.run(cmd + ["--device", "cpu", "synthetic-guardrail", "--families", "nope"],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert run.returncode == 2 and "unknown families" in run.stdout
    run = subprocess.run(cmd + ["normalize", "one"], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert run.returncode == 1 and "--device cpu" in run.stderr


# ----------------------------------------------------- against JAX's CLI


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_guardrail_prints_jax_keys_and_gate_numbers(capsys):
    families = "asr,vad,eou"
    assert jax_main(["synthetic-guardrail", "--families", families]) == 0
    want = _last_json(capsys.readouterr().out)
    assert main(["--device", "cpu", "synthetic-guardrail", "--families", families]) == 0
    got = _last_json(capsys.readouterr().out)
    assert got.pop("torch") == torch.__version__ and want.pop("jax")
    assert got == want
    assert set(got) == {"backend", "families", "trained_asr_wer_pct", "trained_vad_f1_pct",
                        "trained_eou_wer_pct", "trained_eou_detect_pct"}


def _write_wav(path: Path, samples: np.ndarray) -> Path:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype(np.int16).tobytes())
    return path


def _both(monkeypatch, capsys, argv, patches) -> tuple[list[str], list[str]]:
    """stdout lines of JAX's CLI and of the port's on `argv` (the port's with
    `--device cpu`), each with its package's `patches` applied: (module,
    "Name" or "Class.attr", make(real, package) -> replacement)."""
    outs = []
    for pkg, run, extra in (("fluidaudio_tpu", jax_main, []),
                            ("fluidaudio_tpu_torch", main, ["--device", "cpu"])):
        with monkeypatch.context() as m:
            for module, path, make in patches:
                owner = importlib.import_module(f"{pkg}.{module}")
                *outer, name = path.split(".")
                for part in outer:
                    owner = getattr(owner, part)
                m.setattr(owner, name, make(getattr(owner, name), pkg))
            assert run(extra + argv) == 0
        outs.append(capsys.readouterr().out.splitlines())
    return outs[0], outs[1]


def test_transcribe_trained_fixture_prints_jax_text(tmp_path, monkeypatch, capsys):
    """`transcribe` on a 40-word utterance (the chunked path) of the trained
    `asr` fixture: the same text as JAX's CLI, the utterance's words."""
    (ids, audio), = fx.asr_fixture_utterances((40,), seed=7)
    wav = _write_wav(tmp_path / "u.wav", audio)
    ckpt = fx.trained_assets_dir() / "asr"

    def trained(real, pkg):
        return lambda version, allow_random_init, **kw: real(
            "test-tiny", checkpoint_dir=ckpt, allow_random_init=False, **kw)

    want, got = _both(monkeypatch, capsys, ["transcribe", str(wav), "--batch", "2"],
                      [("models.zoo", "AsrModels.load", trained)])
    assert got[0] == want[0] == f"{wav}: {tc.transcript_text(ids)}"


def test_vad_analyze_trained_fixture_prints_jax_segments(tmp_path, monkeypatch, capsys):
    rs = np.random.RandomState(21)
    audio = np.concatenate([np.zeros(16_000, np.float32),
                            tc.make_utterance(rs.randint(0, tc.N_WORDS, size=6), rs),
                            np.zeros(24_000, np.float32),
                            tc.make_utterance(rs.randint(0, tc.N_WORDS, size=4), rs)])
    wav = _write_wav(tmp_path / "v.wav", audio)
    ckpt = fx.trained_assets_dir() / "vad"
    want, got = _both(monkeypatch, capsys, ["vad-analyze", str(wav), "--threshold", "0.5"],
                      [("vad.manager", "VadManager",
                        lambda real, pkg: lambda config, **kw: real(config, checkpoint_dir=ckpt, **kw))])
    assert got[0].split("(")[0] == want[0].split("(")[0]  # the count (timing differs)
    assert got[1:] == want[1:] and len(got) >= 3


def test_diarize_sortformer_rttm_prints_jax_rttm(tmp_path, monkeypatch, capsys):
    """`diarize --mode sortformer --rttm` (the streaming `process`) on the
    trained `sortformer` fixture over a 30 s two-speaker mixture."""
    mix, _, _ = tc.diarizer_mixture(np.random.RandomState(4242), 30.0)
    wav = _write_wav(tmp_path / "meeting.wav", mix)
    ckpt = fx.trained_assets_dir() / "sortformer"
    want, got = _both(monkeypatch, capsys,
                      ["diarize", str(wav), "--mode", "sortformer", "--rttm"],
                      [("diarizer.sortformer", "SortformerDiarizer",
                        lambda real, pkg: lambda **kw: real(
                            importlib.import_module(f"{pkg}.models.sortformer").SORTFORMER_TEST,
                            checkpoint_dir=ckpt, **kw))])
    rttm = [line for line in got if line.startswith("SPEAKER meeting ")]
    assert rttm == [line for line in want if line.startswith("SPEAKER meeting ")] and rttm
    assert got[0].split(",")[:2] == want[0].split(",")[:2]  # segments, speakers


# ------------------------------------------------------- timed commands


def _tiny_managers(monkeypatch, tmp_path):
    """The benchmark commands' full-size managers swapped for test-size ones
    (the canonical modules' attributes, which the commands import)."""
    import fluidaudio_tpu_torch.asr.streaming_eou as eou
    import fluidaudio_tpu_torch.diarizer.sortformer as sf
    import fluidaudio_tpu_torch.models.zoo as zoo
    from fluidaudio_tpu_torch.models.sortformer import SORTFORMER_TEST

    load, eou_cls, sf_cls = zoo.AsrModels.load, eou.StreamingEouAsrManager, sf.SortformerDiarizer
    monkeypatch.setattr(zoo.AsrModels, "load",
                        lambda version, **kw: load("test-tiny", **kw))
    monkeypatch.setattr(eou, "StreamingEouAsrManager",
                        lambda chunk_ms=320, **kw: eou_cls(chunk_ms, spec=eou.EOU_TEST,
                                                           checkpoint_dir=tmp_path, **kw))
    monkeypatch.setattr(sf, "SortformerDiarizer", lambda **kw: sf_cls(SORTFORMER_TEST, **kw))


def test_benchmark_prints_jax_metric_lines(tmp_path, monkeypatch, capsys):
    _tiny_managers(monkeypatch, tmp_path)
    assert main(["--device", "cpu", "benchmark", "--workload", "all", "--batch", "2"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [(r["metric"], r["unit"]) for r in lines] == [
        ("asr_batch_rtfx", "x_realtime"), ("vad_rtfx", "x_realtime"),
        ("eou_streaming_p50_chunk_latency", "ms_per_320ms_chunk"),
        ("sortformer_offline_rtfx", "x_realtime")]
    assert all(r["value"] > 0 for r in lines)


def test_streaming_latency_counts_what_process_emits(tmp_path, monkeypatch, capsys):
    """The N carried chunk steps emit as many tokens as `process` does when
    fed the same chunks (each window as the pending samples of one step)."""
    import fluidaudio_tpu_torch.asr.streaming_eou as eou
    _tiny_managers(monkeypatch, tmp_path)
    n = 6
    assert main(["--device", "cpu", "streaming-latency-benchmark", "--tiers", "160,320",
                 "--chunks", str(n), "--iters", "1"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert out["backend"] == "cpu" and out["chunks"] == n
    for tier in (160, 320):
        row = out[f"eou_{tier}ms"]
        assert set(row) == {"device_per_chunk_ms", "rt_budget_ms", "rt_headroom_x",
                            "dispatch_p50_ms", "dispatch_p95_ms", "tokens_emitted"}
        mgr = eou.StreamingEouAsrManager(tier, device="cpu")
        need = mgr.chunk_samples + eou.MEL_WIN - eou.MEL_HOP
        am = 0.5 * (1 + np.sin(2 * np.pi * 4.0 * np.arange(need) / 16000.0))
        windows = (np.random.RandomState(0).randn(n, 1, need) * 0.1 * am).astype(np.float32)
        state, emitted = mgr.make_state(), 0
        for w in windows:
            state.pending = w[0]
            emitted += len(mgr._process_one(state).token_ids)
        assert row["tokens_emitted"] == emitted > 0


def test_guardrail_baseline_compares_as_jax(tmp_path, capsys):
    """`--baseline`: another backend skips the comparison; another torch
    version drops the `_sha` fields and compares the rest within JAX's
    tolerances, the version key itself included (so, as in JAX, a version
    change alone reads as drift); drift past a tolerance exits 1."""
    argv = ["--device", "cpu", "synthetic-guardrail", "--families", "vad"]
    assert main(argv) == 0
    run = _last_json(capsys.readouterr().out)
    f1 = run["trained_vad_f1_pct"]
    cases = [({"backend": "cuda"}, 0, "skipping comparison"),
             ({"trained_vad_f1_pct": f1 - 4.0}, 0, "within baseline tolerances"),
             ({"trained_vad_f1_pct": f1 - 6.0}, 1, "guardrail DRIFT: trained_vad_f1_pct"),
             ({"torch": "0.0", "vad_prob_sha": "x", "trained_vad_f1_pct": f1 - 4.0}, 1,
              "comparing tolerance-gated fields only\nguardrail DRIFT: torch: ")]
    for i, (edit, rc, says) in enumerate(cases):
        base = tmp_path / f"base{i}.json"
        base.write_text(json.dumps({**run, **edit}))
        assert main(argv + ["--baseline", str(base)]) == rc
        out = capsys.readouterr().out
        assert says in out and "vad_prob_sha" not in out.splitlines()[-1]
