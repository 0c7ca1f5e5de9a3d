"""Registry endpoint resolution + offline enforcement + typed errors.

Copy of `fluidaudio_tpu/registry/registry.py` (it imports nothing of
JAX). The class state (`_offline`, `_programmatic_base`) is this
package's own.

Behavioral parity: reference `ModelRegistry.swift:32-42,90-126` (base URL
priority: programmatic -> REGISTRY_URL -> MODEL_REGISTRY_URL -> huggingface.co;
proxy-aware) and `DownloadUtils.swift:25-64` (`enforceOffline` + typed
`OfflineError`).
"""

from __future__ import annotations

import os
from pathlib import Path


class RegistryError(Exception):
    pass


class OfflineError(RegistryError):
    """Raised when a download is required but offline mode is enforced."""

    def __init__(self, repo: str, detail: str = ""):
        self.repo = repo
        super().__init__(
            f"offline mode enforced but model assets for '{repo}' are not cached"
            + (f": {detail}" if detail else "")
        )


_DEFAULT_BASE = "https://huggingface.co"


class ModelRegistry:
    """Resolves the asset endpoint and local cache layout."""

    _programmatic_base: str | None = None
    _offline: bool | None = None

    @classmethod
    def base_url(cls) -> str:
        if cls._programmatic_base:
            return cls._programmatic_base
        return (
            os.environ.get("REGISTRY_URL")
            or os.environ.get("MODEL_REGISTRY_URL")
            or _DEFAULT_BASE
        )

    @classmethod
    def set_base_url(cls, url: str | None) -> None:
        cls._programmatic_base = url

    @classmethod
    def offline(cls) -> bool:
        if cls._offline is not None:
            return cls._offline
        return os.environ.get("FLUID_OFFLINE", "").lower() in ("1", "true", "yes")

    @classmethod
    def enforce_offline(cls, value: bool = True) -> None:
        cls._offline = value

    @staticmethod
    def cache_dir() -> Path:
        override = os.environ.get("FLUID_CACHE_DIR")
        if override:
            return Path(override)
        return Path.home() / ".cache" / "fluidaudio"

    @staticmethod
    def models_dir() -> Path:
        return ModelRegistry.cache_dir() / "Models"

    @staticmethod
    def hf_token() -> str | None:
        return os.environ.get("HF_TOKEN") or os.environ.get("HUGGING_FACE_HUB_TOKEN")

    @staticmethod
    def proxies() -> dict[str, str]:
        out = {}
        for scheme in ("http", "https"):
            v = os.environ.get(f"{scheme}_proxy") or os.environ.get(f"{scheme.upper()}_PROXY")
            if v:
                out[scheme] = v
        return out
