"""Param tree save/load as npz (flat '/'-joined keys), in numpy.

Checkpoints are param trees converted offline from the upstream NeMo/PyTorch
checkpoints (`fluidaudio_tpu_torch.convert`). A tree is nested dicts, lists
and tuples of arrays. The flat keys and their order are those of the JAX
package's `save_params`: dict keys sorted, list and tuple entries keyed by
index, `None` leaves dropped, every leaf through `np.asarray` with its dtype.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np


def _flatten_with_path(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten_with_path(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten_with_path(v, prefix + (str(i),)))
        return out
    return [(prefix, tree)]


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {"/".join(path): np.asarray(leaf) for path, leaf in _flatten_with_path(tree)}


def _unflatten(template: Any, leaves: dict[tuple, np.ndarray], prefix: tuple = ()) -> Any:
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves, prefix + (str(k),)) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        items = [_unflatten(v, leaves, prefix + (str(i),)) for i, v in enumerate(template)]
        return items if isinstance(template, list) else type(template)(items)
    return leaves[prefix]


def save_params(path: str | Path, tree: Any) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **_flatten(tree))


def load_params(path: str | Path, template: Any) -> Any:
    """Load into the structure of `template` (shapes/dtypes validated)."""
    data = np.load(path)
    flat_template = _flatten(template)
    missing = set(flat_template) - set(data.files)
    extra = set(data.files) - set(flat_template)
    if missing or extra:
        raise ValueError(f"checkpoint mismatch: missing={sorted(missing)[:5]} extra={sorted(extra)[:5]}")
    leaves = {}
    for path_keys, leaf in _flatten_with_path(template):
        key = "/".join(path_keys)
        arr = data[key]
        if arr.shape != np.shape(leaf):
            raise ValueError(f"shape mismatch at {key}: {arr.shape} vs {np.shape(leaf)}")
        leaves[path_keys] = arr.astype(np.asarray(leaf).dtype)
    return _unflatten(template, leaves)
