"""Tiny cells for the CPU tests: the real cells' drivers, mixes and checks at
sizes a test run holds."""

from __future__ import annotations

import copy


def tiny_sortformer(entry, cell, cfg, mix):
    cfg = copy.deepcopy(cfg)
    cfg["encoder"].update(d_model=32, n_layers=1, n_heads=4, subsampling_channels=32, n_mels=128)
    cfg["head"].update(d_model=32, encoder_d_model=32, n_transformer_layers=2, n_heads=4)
    mix = {**mix, "length_s": {"dist": "log_uniform", "min": 40, "max": 60},
           "sizes_per_cycle": 2, "pool_margin_s": 5}
    return entry, cell, cfg, mix
