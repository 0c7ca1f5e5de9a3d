#!/usr/bin/env python3
"""Benchmark of fluidaudio_tpu_torch on one NVIDIA H100: one cell, one run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name from `BENCHMARK.json` at the root
of the checkout: the cell's file `benchmark/workloads/<name>.json` names its
configuration (`benchmark/configs/<config>.json`), its traffic mix
(`benchmark/traffic/<traffic>.json`), its entry driver
(`benchmark/drivers/<driver>.py`) and the limits of its correctness check;
each metric is read by `benchmark/metrics/<metric>.py`. A new cell, mix,
configuration or metric is new files and entries, never an edit.

A run: set-up (weights and audio from the seed, the program built, every
shape the cell uses run once), then a closed loop of one client for
`--seconds`, then the check against the plain reference and one JSON line.
With `--trace 1` the window's first part is timed by the benchmark's spans
(a device sync at each boundary) and its last seconds run under the
profiler; the line then carries the per-layer metrics.

Exits 2 without printing a result when there is no card, fewer cards than
the cell asks for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PROFILED_MAX_S = 4.0


def set_environment() -> None:
    """Caches inside the checkout at fixed paths; no library pulls in JAX."""
    os.environ["TRITON_CACHE_DIR"] = str(BENCH / ".cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BENCH / ".cache" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "4"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, workload: str) -> tuple[dict, dict, dict, dict]:
    """-> (the BENCHMARK.json cell, its file, its configuration, its mix)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(ROOT / configs[entry["config"]]["file"])
    cell = load_json(BENCH / "workloads" / f"{workload}.json")
    mix = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    return entry, cell, cfg, mix


def metrics_for(bench: dict, workload: str, kind: str) -> list[dict]:
    return [m for m in bench[kind] if "workloads" not in m or workload in m["workloads"]]


class Run:
    """What the metric readers read. Beside the window's own numbers, three
    dicts by name, so that a new reader needs new entries, not a new field:
    `host` / `device` (seconds of each span), `calls` (each timed call of a
    wrapped function: device seconds and what the driver described of it)
    and `tally` (the sums of the driver's `tally(request, output)` over the
    timed part of a traced window)."""

    def __init__(self):
        self.setup_s = self.window_s = self.audio_s = 0.0
        self.peak_bytes = 0
        self.part_s = self.part_audio_s = 0.0
        self.host: dict = {}
        self.device: dict = {}
        self.calls: dict = {}
        self.tally: dict = {}
        self.profile: dict | None = None
        self.dtype = "float32"


def window(driver, stream, spans, seconds: float, trace: bool, torch, run: Run):
    """The closed loop: one client sends the next recording when the last
    returns. -> [(request, output, completion time)], requests attempted,
    requests failed. A recording that ends after the window is not counted."""
    done, attempted, failed, log = [], 0, 0, []
    t0 = time.perf_counter()
    end = t0 + seconds
    parts = [("timed", end - min(PROFILED_MAX_S, 0.3 * seconds)), ("profiled", end)] if trace \
        else [("off", end)]
    tally: dict[str, float] = {}
    part_audio = 0.0
    prof = None
    for mode, deadline in parts:
        spans.mode = mode
        if mode == "profiled":
            spans._sync()
            run.part_s = time.perf_counter() - t0
            run.tally = dict(tally)
            run.part_audio_s = part_audio
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            win = torch.profiler.record_function("bench.window")
            win.__enter__()
        first = True  # every part serves at least one recording
        while first or time.perf_counter() < deadline:
            first = False
            req = next(stream)
            attempted += 1
            t_req = time.perf_counter()
            try:
                with spans.host_span("request"):
                    out = driver.serve(req)
            except Exception as e:  # a failed request is counted, the loop goes on
                failed += 1
                print(f"request {req.index} ({req.seconds:.1f} s) failed: {e!r}", file=sys.stderr)
                continue
            t = time.perf_counter()
            log.append(f"request {req.index} {req.seconds:.1f} s audio: {mode} "
                       f"{t - t_req:.3f} s wall, ends {t - t0:.3f} s into the window")
            if mode == "timed":
                for k, v in driver.tally(req, out).items():
                    tally[k] = tally.get(k, 0.0) + v
                part_audio += req.seconds
            if t <= end:
                done.append((req, out, t))
        if mode == "profiled":
            spans._sync()
            win.__exit__(None, None, None)
            prof.__exit__(None, None, None)
    spans.mode = "off"
    print("\n".join(log), file=sys.stderr)
    run.window_s = (done[-1][2] - t0) if done else 0.0
    run.audio_s = sum(r.seconds for r, _, _ in done)
    if prof is not None:
        from yardstick.trace import summarize
        run.profile = summarize(prof)
    return done, attempted, failed


def main(argv=None, *, need_card: bool = True, device: str = "cuda", override=None,
         control: bool = False, fault=None) -> int:
    """One run of one cell. The keyword arguments are for the tests and the
    control: a CPU device and `override(entry, cell, cfg, mix)` giving a tiny
    cell, the program in its lower precision, or a fault planted in the
    timed path (a callable given the driver after set-up)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()
    # the yardstick and the program under test, from this checkout
    sys.path[:0] = [str(BENCH), str(ROOT)]

    bench = load_json(ROOT / "BENCHMARK.json")
    entry, cell, cfg, mix = cell_files(bench, args.workload)
    if override:
        entry, cell, cfg, mix = override(entry, cell, cfg, mix)

    import torch

    if need_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"needs {entry['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)

    import fluidaudio_tpu_torch

    if ROOT not in Path(fluidaudio_tpu_torch.__file__).resolve().parents:
        print(f"the program under test must come from this checkout ({ROOT}), not "
              f"{fluidaudio_tpu_torch.__file__}", file=sys.stderr)
        return 2
    from yardstick.audio import speechlike_pool
    from yardstick.guard import forbidden_modules
    from yardstick.spans import Spans
    from yardstick.traffic import pool_seconds, requests

    torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
    spans = Spans(dev)
    driver_mod = load_module(BENCH / "drivers" / f"{cell['driver']}.py", f"driver_{cell['driver']}")
    trace = bool(args.trace)
    driver = driver_mod.Driver(cfg, cell, mix, args.seed, dev, spans, trace)
    pool = speechlike_pool((args.seed + 1) % 2**63, pool_seconds(mix), dev)
    driver.setup(pool)
    if control:
        driver.use_control()
    if fault is not None:
        fault(driver)
    if trace and dev.type == "cuda":
        # the profiler's first start sets up CUPTI (seconds): not in the window
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize()
    stream = requests(mix, args.seed, len(pool))
    run = Run()
    run.dtype = cfg["dtype"]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - T_START
    done, attempted, failed = window(driver, stream, spans, args.seconds, trace, torch, run)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        run.peak_bytes = torch.cuda.max_memory_allocated()
    if trace:
        run.host = dict(spans.host)
        run.device = spans.device_seconds() if dev.type == "cuda" else {}
        run.calls = spans.call_records()

    driver.release()
    numbers = driver.check([(r, o) for r, o, _ in done]) if done else {}
    limits = cell["limits"]
    compared = {k: (numbers.get(k), limits[k]) for k in limits}
    correct = bool(done) and failed == 0 and all(
        v is not None and v <= lim for v, lim in compared.values())

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, args.workload, kind):
        reader = load_module(BENCH / "metrics" / f"{m['name']}.py", "metric_" + m["name"])
        value = reader.read(run) if done else None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 2
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": entry["chips"], "memory_peak_bytes": run.peak_bytes}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and run.profile is not None:
        device_info["busy_s"] = run.profile["busy_s"]
        device_info["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["extra"] = {k: v for k, v in numbers.items() if k not in limits}
    result["extra"]["completed"] = len(done)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    for k, (v, lim) in compared.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
