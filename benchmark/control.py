#!/usr/bin/env python3
"""The control of a cell's correctness check: one run of the cell with the
program switched to the next precision below the one its configuration
states (the driver's `use_control`; for Sortformer, TF32 for its f32
matmuls and convolutions). Same arguments and output line as `run.py`;
`correct` should come out false, and the numbers it prints are the upper
readings the limits are set below.

    python3 benchmark/control.py --workload <name> --seed <n> --seconds <s>
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run.main(sys.argv[1:] + ["--trace", "0"], control=True))
