"""What a run may load: no JAX, no Flax, no Optax, no JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "fluidaudio_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is, whole,
    one of FORBIDDEN: `fluidaudio_tpu_torch` passes, `fluidaudio_tpu.x` not."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
