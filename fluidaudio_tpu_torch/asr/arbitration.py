"""Dual-decode arbitration: probe decode strategies, commit to the winner.

Behavioral parity: reference `TDT/DualDecodeArbitration.swift:3,45` (opt-in
via `ASRConfig.dualDecodeArbitration`, flag at `AsrTypes.swift:42-63`): on the
v3/no-mel path, decode the FIRST chunks three ways — (A) silence-aligned
starts, (B) silence-aligned + 7-frame warmup prefix, (C) regular stride — and
commit the whole file to the strategy with the highest decode confidence.

The three probes batch trivially (3 rows of the same window through one
pipeline call) instead of three sequential decodes. Port of
`fluidaudio_tpu/asr/arbitration.py`: the call is the port's
`manager.build_pipeline(4)` on the same 4 x 240,000 batch, with no
`finalize` mask, on the models' device, and the counts and confidences come
back to the host once.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from fluidaudio_tpu_torch.asr.config import ASRConfig
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("asr.arbitration")

WARMUP_PREFIX_FRAMES = 7  # path B's explicit warmup probe


@dataclass(frozen=True)
class ArbitrationDecision:
    strategy: str  # "silence_aligned" | "warmup" | "regular"
    confidences: dict[str, float]

    def apply(self, config: ASRConfig) -> ASRConfig:
        if self.strategy == "regular":
            return replace(config, prefer_silence_alignment=False)
        return replace(config, prefer_silence_alignment=True)


def arbitrate(manager, samples: np.ndarray, probe_seconds: float = 15.0
              ) -> ArbitrationDecision:
    """Decode the first window under each strategy; pick the confidence winner.

    `manager` is an AsrManager; only the probe prefix is decoded (one batched
    pipeline call of 3 rows).
    """
    samples = np.asarray(samples, np.float32).reshape(-1)
    n = min(samples.size, int(probe_seconds * 16_000))
    window = samples[:n]
    fpe = 1280

    rows = {
        "silence_aligned": window,
        # warmup: prepend 7 encoder frames of leading silence so the decoder's
        # SOS prior stabilizes before real audio
        "warmup": np.concatenate(
            [np.zeros(WARMUP_PREFIX_FRAMES * fpe, np.float32), window]
        )[:n],
        "regular": window,
    }
    # regular differs by starting mid-energy: offset by half a frame
    rows["regular"] = np.concatenate([window[fpe // 2 :], np.zeros(fpe // 2, np.float32)])

    batch = np.zeros((4, 240_000), np.float32)  # pipeline batches are >=2
    lengths = np.zeros((4,), np.int32)
    keys = list(rows)
    for i, k in enumerate(keys):
        data = rows[k][:240_000]
        batch[i, : data.size] = data
        lengths[i] = data.size

    result, _ = manager.build_pipeline(4)(torch.from_numpy(batch), torch.from_numpy(lengths))
    # one device->host copy: the counts ride as column 0 of the confidences
    host = torch.cat([result.counts[:, None].to(result.confidences.dtype),
                      result.confidences], dim=1).cpu().numpy()
    counts, confs = host[:, 0].astype(np.int64), host[:, 1:]
    confidences = {}
    for i, k in enumerate(keys):
        c = int(counts[i])
        confidences[k] = float(confs[i][:c].mean()) if c else 0.0
    winner = max(confidences, key=confidences.get)
    logger.info("arbitration: %s (confidences %s)", winner, confidences)
    return ArbitrationDecision(strategy=winner, confidences=confidences)
