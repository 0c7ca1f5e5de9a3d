"""One general generator for closed-loop file traffic, driven by a mix file.

A mix (`traffic/<name>.json`) states the recording lengths as a distribution
and how many distinct sizes make one cycle. Every seed gets the same set of
sizes, spaced evenly in the distribution from its least to its greatest
length, both included, in an order of its own per cycle, and its own
offsets into the audio pool: the seed changes the order and the audio,
never the sizes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from yardstick.audio import SAMPLE_RATE


@dataclass(frozen=True)
class Request:
    index: int
    offset: int  # first sample in the pool
    samples: int

    @property
    def seconds(self) -> float:
        return self.samples / SAMPLE_RATE


def sizes(mix: dict) -> list[int]:
    """The cycle's recording lengths in samples, shortest first."""
    dist, n = mix["length_s"], int(mix["sizes_per_cycle"])
    lo, hi = float(dist["min"]), float(dist["max"])
    at = [i / (n - 1) for i in range(n)] if n > 1 else [0.5]
    if dist["dist"] == "log_uniform":
        secs = [math.exp(math.log(lo) + a * (math.log(hi) - math.log(lo))) for a in at]
    elif dist["dist"] == "uniform":
        secs = [lo + a * (hi - lo) for a in at]
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return [int(round(s * SAMPLE_RATE)) for s in secs]


def pool_seconds(mix: dict) -> float:
    """Pool length: the longest recording plus the mix's margin."""
    return float(mix["length_s"]["max"]) + float(mix.get("pool_margin_s", 60.0))


def requests(mix: dict, seed: int, pool_samples: int) -> Iterator[Request]:
    """Endless stream of requests: each cycle is the mix's sizes in a fresh
    order drawn from the seed, each at a seeded offset into the pool."""
    rs = np.random.default_rng(seed)
    cycle = sizes(mix)
    index = 0
    while True:
        for k in rs.permutation(len(cycle)):
            n = cycle[int(k)]
            offset = int(rs.integers(0, pool_samples - n + 1))
            yield Request(index, offset, n)
            index += 1
