#!/usr/bin/env python3
"""The device operations launched inside each of the port's spans, in one
traced run of the benchmark.

    python3 scripts/torch_head_ops.py --seed <n> [--root <checkout>] [--seconds 51]
        [--workload sortformer_offline] [--top 15]

Runs `<root>/benchmark/run.py` in this process with `--trace 1` (the
checkout given by `--root`, this one by default, so a parent's checkout can
be read the same way) and prints its JSON line. Over the profiled
sub-window it then names every kernel and copy by the innermost program
span (`fluidaudio_tpu_torch.utils.profiling`) whose host stamps hold the
runtime call that launched it (kineto's correlation ids), and prints for
`sortformer.head`, `encoder` and `mel` the device seconds of each operation
and their sum in ms per audio minute (over the `audio_s` the profiled
`diar.request` spans count). The same goes to
`chiprun_out/head_ops_<seed>.json`. Prints the card's name and power limit
first. Needs one NVIDIA GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHOWN = ("sortformer.head", "encoder", "mel")


def attribute(prof, records) -> tuple[dict, int, int]:
    """-> ({span name: {op name: device s}}, device events, events matched
    to a launch)."""
    launch_ns: dict[int, int] = {}
    device = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name == "CUDA":
            device.append(e)
        elif e.name().startswith(("cuda", "cu")):
            launch_ns[e.correlation_id()] = e.start_ns()
    spans = sorted(((r.start_ns, r.end_ns, r.name) for r in records), key=lambda s: s[0])
    by_span: dict[str, dict[str, float]] = defaultdict(lambda: defaultdict(float))
    matched = 0
    for e in device:
        t = launch_ns.get(e.correlation_id())
        if t is None:
            continue
        matched += 1
        best = None
        for s, end, name in spans:
            if s > t:
                break
            if t < end and (best is None or end - s < best[1] - best[0]):
                best = (s, end, name)
        by_span[best[2] if best else "none"][e.name()] += e.duration_ns() / 1e9
    return by_span, len(device), matched


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--workload", default="sortformer_offline")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    root = args.root.resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)

    sys.path[:0] = [str(root / "benchmark"), str(root)]
    import importlib.util

    import yardstick.trace as trace

    seen = {}
    summarize = trace.summarize

    def keep(prof, *a, **kw):
        from fluidaudio_tpu_torch.utils import profiling

        seen["ops"] = attribute(prof, profiling.spans())
        seen["summary"] = profiling.summary()
        return summarize(prof, *a, **kw)

    trace.summarize = keep
    spec = importlib.util.spec_from_file_location("bench_run", root / "benchmark" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0 or "ops" not in seen:
        print(f"the run gave {rc}, no profile", file=sys.stderr)
        return rc or 1
    by_span, n_device, matched = seen["ops"]
    summary = seen["summary"]
    audio_min = summary.get("diar.request", {}).get("counts", {}).get("audio_s", 0.0) / 60
    print(f"[{smi}] root {root}, seed {args.seed}: {n_device} device events, {matched} matched "
          f"to their launch; {audio_min:.2f} audio minutes profiled")
    out = {"card": smi, "root": str(root), "seed": args.seed, "audio_min": audio_min,
           "device_events": n_device, "matched": matched, "spans": {}}
    for name in list(SHOWN) + sorted(set(by_span) - set(SHOWN)):
        ops = by_span.get(name)
        if not ops:
            continue
        total = sum(ops.values())
        rows = sorted(ops.items(), key=lambda x: -x[1])
        out["spans"][name] = {"device_s": total, "ops": rows,
                              "counts": summary.get(name, {}).get("counts", {})}
        if name not in SHOWN:
            continue
        per_min = total * 1e3 / audio_min if audio_min else float("nan")
        print(f"span {name}: {total:.6f} device s over {len(ops)} ops, {per_min:.4f} ms per "
              f"audio minute; counts {summary.get(name, {}).get('counts', {})}")
        for op, sec in rows[: args.top]:
            print(f"  {sec:.6f} s  {sec * 1e3 / audio_min:.4f} ms/min  {op[:110]}")
    dest = REPO / "chiprun_out" / f"head_ops_{args.seed}.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
