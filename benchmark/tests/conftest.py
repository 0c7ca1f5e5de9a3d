"""The benchmark's tests import its own modules (`run`, `yardstick`,
`reference`) and the program from the checkout's root."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH), str(BENCH / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)
