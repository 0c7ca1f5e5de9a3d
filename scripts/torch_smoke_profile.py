#!/usr/bin/env python3
"""Where the wall time of `chip_smoke.py` goes, on one NVIDIA GPU.

    python3 scripts/torch_smoke_profile.py

Runs `chip_smoke.main()` as `python3 chip_smoke.py` would, with every
top-level function of `chip_smoke` wrapped in a timer. When it ends (or
fails) it prints, to standard error and to `chiprun_out/smoke_profile.txt`,
each function's inclusive wall seconds and call count, largest first, then
the whole run's seconds and return code. Inclusive: a phase's line holds the
helpers it calls, which have lines of their own. The card's name and power
limit are on `chip_smoke.py`'s own phase-1 line.
"""

from __future__ import annotations

import functools
import inspect
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

stats: dict[str, list] = {}


def timed(name: str, fn):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            entry = stats.setdefault(name, [0, 0.0])
            entry[0] += 1
            entry[1] += time.perf_counter() - t0
    return inner


def main() -> int:
    for name, obj in list(vars(chip_smoke).items()):
        if (inspect.isfunction(obj) and obj.__module__ == chip_smoke.__name__
                and name not in ("main", "check")):
            setattr(chip_smoke, name, timed(name, obj))
    t0, rc = time.perf_counter(), 1
    try:
        rc = chip_smoke.main()
    finally:
        rows = sorted(stats.items(), key=lambda kv: -kv[1][1])
        text = "\n".join(f"{v[1]:9.1f} s {v[0]:5d} calls  {k}" for k, v in rows)
        text += f"\ntotal {time.perf_counter() - t0:.1f} s rc {rc}\n"
        out = REPO / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "smoke_profile.txt").write_text(text)
        print(text, file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
