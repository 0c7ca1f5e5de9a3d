"""Per-category loggers with env-based level filtering.

Behavioral parity: reference `Shared/AppLogger.swift:6-130` (os.Logger wrapper,
per-category, level filter via env). Here: stdlib logging, category = child
logger of "fluidaudio", level from FLUID_LOG_LEVEL (debug/info/warning/error).
"""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "fluidaudio"
_CONFIGURED = False

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "warn": logging.WARNING,
    "error": logging.ERROR,
    "fault": logging.CRITICAL,
}


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    root = logging.getLogger(_ROOT)
    level_name = os.environ.get("FLUID_LOG_LEVEL", "info").lower()
    root.setLevel(_LEVELS.get(level_name, logging.INFO))
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s [%(name)s] %(levelname)s: %(message)s", "%H:%M:%S")
        )
        root.addHandler(handler)
    root.propagate = False
    _CONFIGURED = True


def get_logger(category: str = "core") -> logging.Logger:
    """Return the logger for a category (e.g. "asr", "vad", "diarizer.offline")."""
    _configure()
    return logging.getLogger(f"{_ROOT}.{category}")
