"""Asset readiness: per-family validation, corrupt-cache auto-recovery.

Copy of `fluidaudio_tpu/registry/doctor.py` (it imports nothing of
JAX), with its imports pointed at this package.

Behavioral parity:
  * `AsrModels.loadWithAutoRecovery` (`TDT/AsrModels.swift:425-435`) and
    `DownloadUtils.loadModels`'s cache-validity check + re-download
    (`DownloadUtils.swift:310-344`): a load that finds missing or corrupt
    artifacts repairs the cache (delete + re-fetch) instead of crashing,
    and in offline mode raises a typed error listing exactly what's missing.
  * The per-family `requiredModels` sets (`ModelNames.swift:278-700`) via
    `model_names.required_models`.

The `doctor` CLI (`fluidaudio doctor`) renders `readiness_report()` so
weights day is turnkey for every family: one command says which model
bundles are cached, valid, incomplete, or absent.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

from fluidaudio_tpu_torch.registry.download import DownloadUtils
from fluidaudio_tpu_torch.registry.model_names import FAMILIES, Repo, required_models
from fluidaudio_tpu_torch.registry.registry import ModelRegistry, OfflineError, RegistryError
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("registry.doctor")


@dataclass
class RepoStatus:
    repo: Repo
    required: tuple[str, ...]
    present: list[str] = field(default_factory=list)
    missing: list[str] = field(default_factory=list)
    corrupt: list[str] = field(default_factory=list)

    @property
    def ready(self) -> bool:
        return not self.missing and not self.corrupt

    @property
    def state(self) -> str:
        if self.ready:
            return "ready"
        if self.corrupt:
            return "corrupt"
        if self.present:
            return "incomplete"
        return "absent"

    def to_dict(self) -> dict:
        return {
            "repo": self.repo.name.lower().replace("_", "-"),
            "remote": self.repo.remote_path,
            "folder": str(DownloadUtils.repo_dir(self.repo)),
            "state": self.state,
            "present": sorted(self.present),
            "missing": sorted(self.missing),
            "corrupt": sorted(self.corrupt),
        }


def validate_file(path: Path) -> bool:
    """True iff a cached artifact is loadable for its type.

    npz: numpy can open the zip and it holds >=1 array entry (a truncated
    download or an HTML error page cached as .npz fails here). json: parses.
    Anything else: non-empty.
    """
    try:
        if path.suffix == ".npz":
            import numpy as np

            with np.load(path, allow_pickle=False) as z:
                return len(z.files) > 0
        if path.suffix == ".json":
            json.loads(path.read_text())
            return True
        return path.stat().st_size > 0
    except Exception:  # corrupt zip / truncated file / bad JSON
        return False


def check_repo(repo: Repo, variant: str | None = None, *,
               deep: bool = True) -> RepoStatus:
    """Inventory one repo's cache against its required-model set."""
    req = required_models(repo, variant)
    status = RepoStatus(repo=repo, required=req)
    d = DownloadUtils.repo_dir(repo)
    for name in req:
        p = d / name
        if not p.exists():
            status.missing.append(name)
        elif deep and not validate_file(p):
            status.corrupt.append(name)
        else:
            status.present.append(name)
    return status


def repair_repo(repo: Repo, variant: str | None = None) -> RepoStatus:
    """Fetch missing artifacts and re-fetch corrupt ones.

    Offline mode: raises `OfflineError` naming the exact missing files, the
    reference's `OfflineError.modelMissing` contract
    (`DownloadUtils.swift:323-334`).
    """
    status = check_repo(repo, variant)
    if status.ready:
        return status
    needed = status.missing + status.corrupt
    if ModelRegistry.offline():
        raise OfflineError(repo.spec.name, ", ".join(sorted(needed)))
    d = DownloadUtils.repo_dir(repo)
    for name in status.corrupt:
        logger.warning("%s: corrupt cached %s — re-downloading", repo.folder_name, name)
        (d / name).unlink(missing_ok=True)
    for name in needed:
        DownloadUtils.fetch_file(repo, name, force=name in status.corrupt)
    return check_repo(repo, variant)


def ensure_repo(repo: Repo, variant: str | None = None) -> Path:
    """Load-with-auto-recovery entry point for family loaders: returns the
    cache dir once every required artifact is present and valid; repairs the
    cache if it can, raises a typed error naming what's missing if it can't."""
    status = check_repo(repo, variant)
    if not status.ready:
        status = repair_repo(repo, variant)
        if not status.ready:
            raise RegistryError(
                f"{repo.spec.name}: cache unrecoverable; still bad after repair: "
                f"missing={sorted(status.missing)} corrupt={sorted(status.corrupt)}"
            )
    return DownloadUtils.repo_dir(repo)


def readiness_report(*, deep: bool = True) -> dict:
    """Per-family readiness over the whole catalog (the `doctor` CLI body).

    A family is "ready" if ANY of its repos is fully cached (families list
    alternates: latency tiers, language variants, dataset builds)."""
    families = {}
    for key, (label, repos) in FAMILIES.items():
        statuses = [check_repo(r, deep=deep) for r in repos]
        families[key] = {
            "label": label,
            "ready": any(s.ready for s in statuses),
            "repos": [s.to_dict() for s in statuses],
        }
    return {
        "models_dir": str(ModelRegistry.models_dir()),
        "offline": ModelRegistry.offline(),
        "families_ready": sum(1 for f in families.values() if f["ready"]),
        "families_total": len(families),
        "families": families,
    }
