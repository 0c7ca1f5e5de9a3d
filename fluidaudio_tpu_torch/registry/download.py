"""Asset download with resume/retry/backoff, validation, and cache recovery.

Copy of `fluidaudio_tpu/registry/download.py` (it imports nothing of
JAX), with its imports pointed at this package.

Behavioral parity: reference `DownloadUtils.swift:210-260,414-511,760-866` —
HF listing walk, exponential-backoff retry, HTML-response artifact detection
(`DownloadUtils.swift:103-143`), corrupt-asset auto-redownload, and typed
offline errors. Network is optional: with `FLUID_OFFLINE` (or no egress) only
the local cache is consulted.
"""

from __future__ import annotations

import http.client
import json
import shutil
import time
import urllib.error
import urllib.request
from pathlib import Path

from fluidaudio_tpu_torch.registry.model_names import Repo
from fluidaudio_tpu_torch.registry.registry import ModelRegistry, OfflineError, RegistryError
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("registry")

_MAX_RETRIES = 4
_BACKOFF_BASE_S = 1.5


def validate_artifact(path, expected_size: int | None = None,
                      content_type: str | None = None) -> None:
    """Validate a downloaded artifact like the reference
    (`DownloadUtils.swift:103-143`): reject HTML content-types, empty
    bodies, HTML bodies served as binary, and size mismatches against the
    server's Content-Length (truncated OR oversized). `expected_size=None`
    (unknown length) skips the size check. Raises RegistryError."""
    from pathlib import Path as _Path

    p = _Path(path)
    if content_type and "text/html" in content_type.lower():
        raise RegistryError(f"{p.name}: server returned text/html (bad path or auth)")
    size = p.stat().st_size
    if size == 0:
        raise RegistryError(f"{p.name}: empty response body")
    with p.open("rb") as f:
        head = f.read(64)
    if _looks_like_html(head):
        raise RegistryError(f"{p.name}: HTML body served as binary (bad path or auth)")
    if expected_size is not None and expected_size >= 0 and size != expected_size:
        kind = "truncated" if size < expected_size else "oversized"
        raise RegistryError(
            f"{p.name}: {kind} body ({size} bytes, expected {expected_size})"
        )


def _looks_like_html(head: bytes) -> bool:
    """HF serves an HTML error page on bad paths (and some proxies an XML
    envelope); never cache those as weights (ref `DownloadUtils.swift:103-143`,
    `DownloadArtifactValidationTests.swift:64-86`)."""
    stripped = head.lstrip()[:32].lower()
    return (
        stripped.startswith(b"<!doctype html")
        or stripped.startswith(b"<html")
        or stripped.startswith(b"<?xml")
    )


class DownloadUtils:
    @staticmethod
    def repo_dir(repo: Repo) -> Path:
        return ModelRegistry.models_dir() / repo.folder_name

    @staticmethod
    def is_cached(repo: Repo, files: tuple[str, ...] = ()) -> bool:
        d = DownloadUtils.repo_dir(repo)
        if not d.is_dir():
            return False
        return all((d / f).exists() for f in files)

    @staticmethod
    def fetch_file(repo: Repo, remote_path: str, *, force: bool = False) -> Path:
        """Download one file into the cache (resumable, validated). Returns path."""
        dest = DownloadUtils.repo_dir(repo) / remote_path
        if dest.exists() and not force:
            return dest
        if ModelRegistry.offline():
            raise OfflineError(repo.spec.name, remote_path)

        # Variant repos (Kokoro ANE packs, EOU/Nemotron latency tiers, LS-EEND
        # dataset builds, Cohere q8, StyleTTS2 iteration dirs) live under a
        # repo subdirectory (`ModelNames.swift` subPath); the cache folder
        # stays flat per-variant so artifact names never collide.
        remote = (
            f"{repo.spec.sub_path}/{remote_path}" if repo.spec.sub_path else remote_path
        )
        url = f"{ModelRegistry.base_url()}/{repo.spec.name}/resolve/main/{remote}"
        dest.parent.mkdir(parents=True, exist_ok=True)
        tmp = dest.with_suffix(dest.suffix + ".part")

        headers = {}
        token = ModelRegistry.hf_token()
        if token:
            headers["Authorization"] = f"Bearer {token}"

        last_err: Exception | None = None
        for attempt in range(_MAX_RETRIES):
            try:
                offset = tmp.stat().st_size if tmp.exists() else 0
                req_headers = dict(headers)
                if offset:
                    req_headers["Range"] = f"bytes={offset}-"
                req = urllib.request.Request(url, headers=req_headers)
                expected_size: int | None = None
                content_type: str | None = None
                try:
                    with urllib.request.urlopen(req, timeout=60) as resp:
                        mode = "ab" if offset and resp.status == 206 else "wb"
                        content_type = resp.headers.get("Content-Type")
                        clen = resp.headers.get("Content-Length")
                        if clen is not None:
                            # 206 reports the REMAINING bytes; 200 the total
                            expected_size = int(clen) + (
                                offset if mode == "ab" else 0
                            )
                        with open(tmp, mode) as f:
                            shutil.copyfileobj(resp, f, length=1 << 20)
                except urllib.error.HTTPError as e:
                    if e.code != 416 or not offset:
                        raise
                    # Range past EOF: the .part already holds the full file
                    # (a previous run crashed between write and rename) —
                    # without this, every later attempt re-sends the same
                    # Range and wedges on 416 forever
                try:
                    validate_artifact(tmp, expected_size, content_type)
                except RegistryError:
                    tmp.unlink(missing_ok=True)
                    raise
                tmp.rename(dest)
                return dest
            except (urllib.error.URLError, TimeoutError, OSError, RegistryError,
                    http.client.HTTPException) as e:
                last_err = e
                wait = _BACKOFF_BASE_S * (2**attempt)
                logger.warning("download %s attempt %d failed (%s); retry in %.1fs",
                               remote_path, attempt + 1, e, wait)
                time.sleep(wait)
        raise RegistryError(f"failed to download {url}: {last_err}")

    @staticmethod
    def fetch_hf_file(
        repo_id: str,
        remote_path: str,
        dest_dir: Path,
        *,
        revision: str = "main",
        dataset: bool = False,
        force: bool = False,
    ) -> Path:
        """Fetch one file from an arbitrary HF repo (model or dataset) at a
        pinned revision — same auth/retry/HTML-validation treatment as the
        catalog pulls (reference `DownloadUtils.fetchHuggingFaceFile`)."""
        # cache keyed by revision (a "main" fetch must not satisfy a
        # pinned-revision request with different bytes)
        sub = "" if revision == "main" else f"rev-{revision[:12]}/"
        dest = Path(dest_dir) / f"{sub}{remote_path}"
        if dest.exists() and not force:
            return dest
        if ModelRegistry.offline():
            raise OfflineError(repo_id, remote_path)

        kind = "datasets/" if dataset else ""
        url = (f"{ModelRegistry.base_url()}/{kind}{repo_id}"
               f"/resolve/{revision}/{remote_path}")
        dest.parent.mkdir(parents=True, exist_ok=True)

        headers = {}
        token = ModelRegistry.hf_token()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        last_err: Exception | None = None
        for attempt in range(_MAX_RETRIES):
            try:
                req = urllib.request.Request(url, headers=headers)
                tmp = dest.with_suffix(dest.suffix + ".part")
                with urllib.request.urlopen(req, timeout=60) as resp:
                    with open(tmp, "wb") as f:
                        shutil.copyfileobj(resp, f, length=1 << 20)
                if _looks_like_html(tmp.open("rb").read(64)):
                    tmp.unlink(missing_ok=True)
                    raise RegistryError(f"HTML response for {url} (bad path or auth)")
                tmp.rename(dest)
                return dest
            except (urllib.error.URLError, TimeoutError, OSError, RegistryError,
                    http.client.HTTPException) as e:
                last_err = e
                wait = _BACKOFF_BASE_S * (2**attempt)
                logger.warning("download %s attempt %d failed (%s); retry in %.1fs",
                               remote_path, attempt + 1, e, wait)
                time.sleep(wait)
        raise RegistryError(f"failed to download {url}: {last_err}")

    @staticmethod
    def list_repo_files(repo: Repo, subdir: str = "") -> list[str]:
        """Walk the HF listing API (`/api/models/<id>/tree/main[/<dir>]`).

        Reference `DownloadUtils.downloadSubdirectory` listing walk.
        """
        if ModelRegistry.offline():
            raise OfflineError(repo.spec.name, f"listing {subdir or '/'}")
        base = ModelRegistry.base_url()
        url = f"{base}/api/models/{repo.spec.name}/tree/main"
        prefix = "/".join(p for p in (repo.spec.sub_path, subdir.strip("/")) if p)
        if prefix:
            url += f"/{prefix}"
        headers = {}
        token = ModelRegistry.hf_token()
        if token:
            headers["Authorization"] = f"Bearer {token}"

        def fetch_page(page_url: str) -> tuple[list, str | None]:
            last_err: Exception | None = None
            for attempt in range(_MAX_RETRIES):
                try:
                    req = urllib.request.Request(page_url, headers=headers)
                    with urllib.request.urlopen(req, timeout=60) as resp:
                        # HF paginates the tree API via a Link rel="next" header
                        link = resp.headers.get("Link", "")
                        nxt = None
                        for part in link.split(","):
                            if 'rel="next"' in part and "<" in part:
                                nxt = part[part.index("<") + 1 : part.index(">")]
                        return json.loads(resp.read().decode()), nxt
                except (urllib.error.URLError, TimeoutError, OSError,
                        http.client.HTTPException, ValueError) as e:
                    last_err = e
                    time.sleep(_BACKOFF_BASE_S * (2**attempt))
            raise RegistryError(f"failed to list {page_url}: {last_err}")

        files: list[str] = []
        page: str | None = url
        sub_prefix = f"{repo.spec.sub_path}/" if repo.spec.sub_path else ""

        def relative(path: str) -> str:
            # The tree API returns repo-absolute paths; callers (fetch_file,
            # recursion) speak sub_path-relative, so strip the variant prefix.
            if sub_prefix and path.startswith(sub_prefix):
                return path[len(sub_prefix):]
            return path

        while page:
            entries, page = fetch_page(page)
            for entry in entries:
                if entry.get("type") == "file":
                    files.append(relative(entry["path"]))
                elif entry.get("type") == "directory":
                    files.extend(
                        DownloadUtils.list_repo_files(repo, relative(entry["path"]))
                    )
        return files

    @staticmethod
    def download_subdirectory(repo: Repo, subdir: str) -> Path:
        """Fetch every file under a repo subdirectory into the cache."""
        for f in DownloadUtils.list_repo_files(repo, subdir):
            DownloadUtils.fetch_file(repo, f)
        return DownloadUtils.repo_dir(repo) / subdir

    @staticmethod
    def download_repo(repo: Repo, files: tuple[str, ...]) -> Path:
        """Ensure the listed files exist in the cache; returns the repo dir."""
        for f in files:
            DownloadUtils.fetch_file(repo, f)
        return DownloadUtils.repo_dir(repo)

    @staticmethod
    def clear_model_cache(repo: Repo | None = None) -> None:
        target = DownloadUtils.repo_dir(repo) if repo else ModelRegistry.models_dir()
        if target.exists():
            shutil.rmtree(target)

    @staticmethod
    def load_json(repo: Repo, remote_path: str) -> dict:
        """Fetch (or read cached) JSON with corrupt-file auto-redownload."""
        path = DownloadUtils.fetch_file(repo, remote_path)
        try:
            return json.loads(path.read_text())
        except (json.JSONDecodeError, UnicodeDecodeError):
            logger.warning("corrupt cached %s; re-downloading", path)
            path.unlink(missing_ok=True)
            path = DownloadUtils.fetch_file(repo, remote_path, force=True)
            return json.loads(path.read_text())
