"""The device an entry point runs on: the card unless the caller says otherwise."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """`None` means the first CUDA device; raises RuntimeError when there is
    none, naming `device="cpu"`, rather than running on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; "
            'pass device="cpu" to run on the CPU')
    return torch.device("cuda", torch.cuda.current_device())
