from fluidaudio_tpu_torch.registry.model_names import FAMILIES, Repo, required_models
from fluidaudio_tpu_torch.registry.registry import ModelRegistry, OfflineError, RegistryError
from fluidaudio_tpu_torch.registry.download import DownloadUtils
from fluidaudio_tpu_torch.registry.doctor import (
    check_repo,
    ensure_repo,
    readiness_report,
    repair_repo,
)

__all__ = [
    "FAMILIES",
    "Repo",
    "required_models",
    "check_repo",
    "ensure_repo",
    "readiness_report",
    "repair_repo",
    "ModelRegistry",
    "OfflineError",
    "RegistryError",
    "DownloadUtils",
]
