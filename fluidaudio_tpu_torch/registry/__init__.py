from fluidaudio_tpu_torch.registry.model_names import FAMILIES, Repo, required_models

__all__ = [
    "FAMILIES",
    "Repo",
    "required_models",
    # not ported yet: ModelRegistry, OfflineError, RegistryError, DownloadUtils
    # and the doctor helpers (registry/{registry,download,doctor}.py)
]
