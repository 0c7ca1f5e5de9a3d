"""Seeded weights made on the device in one draw per served dtype.

A spec is [(name, shape, kind, dtype)]: `w` LeCun-normal (std fan_in^-1/2,
fan_in the product of the shape past the first axis), `b` biases N(0, 0.02),
`ln` norm scales 1 + N(0, 0.02), `emb` embeddings N(0, 0.02), `unit` N(0, 1). The draw is one
`torch.randn` per dtype on a generator on the card; each leaf is a scaled
slice of it, cast once to the dtype it is served in. The program and the
reference are given the same tensors.
"""

from __future__ import annotations

import math

import torch


def make_weights(spec: list[tuple[str, tuple[int, ...], str, str]], seed: int,
                 device: torch.device) -> dict[str, torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(seed)
    out: dict[str, torch.Tensor] = {}
    for dtype in sorted({d for *_, d in spec}):
        leaves = [(n, s, k) for n, s, k, d in spec if d == dtype]
        total = sum(math.prod(s) for _, s, _ in leaves)
        flat = torch.randn(total, generator=g, device=device)
        at = 0
        for name, shape, kind in leaves:
            n = math.prod(shape)
            z = flat[at:at + n].view(shape)
            at += n
            if kind == "w":
                x = z * math.prod(shape[1:]) ** -0.5
            elif kind in ("b", "emb"):
                x = z * 0.02
            elif kind == "unit":
                x = z
            elif kind == "ln":
                x = 1.0 + z * 0.02
            else:
                raise ValueError(f"unknown weight kind {kind!r} for {name}")
            out[name] = x.to(getattr(torch, dtype))
        del flat
    return out
