"""Host/accelerator info + peak RSS (reference `Shared/SystemInfo.swift:11`).

Port of `fluidaudio_tpu/utils/system_info.py`: the accelerators are torch's
CUDA devices, by name.
"""

from __future__ import annotations

import os
import platform
from dataclasses import dataclass, field

import torch

from fluidaudio_tpu_torch.native.sysinfo import current_rss_bytes, peak_rss_bytes


@dataclass
class SystemInfo:
    os_name: str = field(default_factory=platform.system)
    os_version: str = field(default_factory=platform.release)
    python_version: str = field(default_factory=platform.python_version)
    cpu_count: int = field(default_factory=lambda: os.cpu_count() or 1)

    @staticmethod
    def accelerators() -> list[str]:
        """The CUDA devices' names; [] only when torch sees no CUDA device
        (a failing CUDA query raises rather than reading as none)."""
        if not torch.cuda.is_available():
            return []
        return [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]

    @staticmethod
    def peak_memory_mb() -> float:
        return peak_rss_bytes() / (1024 * 1024)

    @staticmethod
    def current_memory_mb() -> float:
        return current_rss_bytes() / (1024 * 1024)

    def summary(self) -> str:
        return (
            f"{self.os_name} {self.os_version} · python {self.python_version} · "
            f"{self.cpu_count} cpus · peak {self.peak_memory_mb():.0f} MB"
        )
