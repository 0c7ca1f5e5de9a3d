"""StreamingModelVariant catalog + factory.

Behavioral parity: reference `Streaming/ParakeetModelVariant.swift`
(`StreamingModelVariant` enum, exercised by `StreamingAsrManagerTests`):
every cache-aware / chunked-attention streaming variant with its display
name, HF repo, and tier parameters, plus `create_manager()` instantiating
the right engine. Parakeet TDT pseudo-streaming is deliberately NOT listed
(use `SlidingWindowAsrManager` directly), mirroring the reference note.

Port of `fluidaudio_tpu/asr/streaming_variants.py`: the same catalog, and
every family resolves to the port's engine; `kwargs` pass through, `device=`
included (None: the GPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from fluidaudio_tpu_torch.registry.model_names import Repo


@dataclass(frozen=True)
class StreamingVariant:
    key: str  # raw value, e.g. "parakeet-eou-320ms"
    display_name: str
    family: str  # "eou" | "nemotron" | "unified" | "unified-offline"
    repo: Repo
    chunk_ms: int | None = None  # eou/nemotron cache-aware tiers
    chunk_seconds: float | None = None  # unified [chunk|right] windows
    right_context_seconds: float | None = None
    latency_ms: int | None = None  # advertised end-to-end latency


_V = StreamingVariant
STREAMING_VARIANTS: dict[str, StreamingVariant] = {
    v.key: v
    for v in (
        # Parakeet EOU 120M (conformer caches)
        _V("parakeet-eou-160ms", "Parakeet EOU 120M (160ms)", "eou",
           Repo.PARAKEET_EOU, chunk_ms=160, latency_ms=160),
        _V("parakeet-eou-320ms", "Parakeet EOU 120M (320ms)", "eou",
           Repo.PARAKEET_EOU, chunk_ms=320, latency_ms=320),
        _V("parakeet-eou-1280ms", "Parakeet EOU 120M (1280ms)", "eou",
           Repo.PARAKEET_EOU, chunk_ms=1280, latency_ms=1280),
        # Nemotron 0.6B en (conformer caches, int8 encoder upstream)
        _V("nemotron-560ms", "Nemotron 0.6B (560ms)", "nemotron",
           Repo.NEMOTRON_EN, chunk_ms=560, latency_ms=560),
        _V("nemotron-1120ms", "Nemotron 0.6B (1120ms)", "nemotron",
           Repo.NEMOTRON_EN, chunk_ms=1120, latency_ms=1120),
        _V("nemotron-2240ms", "Nemotron 0.6B (2240ms)", "nemotron",
           Repo.NEMOTRON_EN, chunk_ms=2240, latency_ms=2240),
        # Parakeet Unified 0.6B (stateless [left|chunk|right] re-encode);
        # latency = chunk + right context (ParakeetModelVariant.swift tiers)
        _V("parakeet-unified-320ms", "Parakeet Unified 0.6B (320ms)",
           "unified", Repo.PARAKEET_UNIFIED,
           chunk_seconds=0.16, right_context_seconds=0.16, latency_ms=320),
        _V("parakeet-unified-640ms", "Parakeet Unified 0.6B (640ms)",
           "unified", Repo.PARAKEET_UNIFIED,
           chunk_seconds=0.56, right_context_seconds=0.08, latency_ms=640),
        _V("parakeet-unified-1120ms", "Parakeet Unified 0.6B (1120ms)",
           "unified", Repo.PARAKEET_UNIFIED,
           chunk_seconds=0.56, right_context_seconds=0.56, latency_ms=1120),
        _V("parakeet-unified-2080ms", "Parakeet Unified 0.6B (2080ms)",
           "unified", Repo.PARAKEET_UNIFIED,
           chunk_seconds=1.04, right_context_seconds=1.04, latency_ms=2080),
        _V("parakeet-unified-offline-15s", "Parakeet Unified 0.6B (offline 15s)",
           "unified-offline", Repo.PARAKEET_UNIFIED),
    )
}


def create_streaming_manager(variant: str | StreamingVariant, **kwargs: Any):
    """Instantiate the engine for a variant key (reference
    `StreamingModelVariant.createManager()`); kwargs pass through to the
    engine constructor. Raises KeyError on unknown variants."""
    v = STREAMING_VARIANTS[variant] if isinstance(variant, str) else variant
    if v.family == "eou":
        from fluidaudio_tpu_torch.asr.streaming_eou import StreamingEouAsrManager

        return StreamingEouAsrManager(chunk_ms=v.chunk_ms, **kwargs)
    if v.family == "nemotron":
        from fluidaudio_tpu_torch.asr.streaming_nemotron import (
            NEMOTRON_EN,
            StreamingNemotronAsrManager,
        )

        return StreamingNemotronAsrManager(
            kwargs.pop("spec", NEMOTRON_EN), chunk_ms=v.chunk_ms, **kwargs
        )
    if v.family == "unified":
        from fluidaudio_tpu_torch.asr.unified import (
            StreamingUnifiedAsrManager,
            UnifiedStreamingConfig,
        )

        cfg = kwargs.pop("config", None) or UnifiedStreamingConfig(
            chunk_seconds=v.chunk_seconds,
            right_context_seconds=v.right_context_seconds,
        )
        return StreamingUnifiedAsrManager(config=cfg, **kwargs)
    if v.family == "unified-offline":
        from fluidaudio_tpu_torch.asr.unified import UnifiedAsrManager

        return UnifiedAsrManager(**kwargs)
    raise ValueError(f"unknown streaming family {v.family!r}")
