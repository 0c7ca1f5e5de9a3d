"""Benchmark dataset downloaders & staging.

Copy of `fluidaudio_tpu/registry/datasets.py` (it imports nothing of
JAX); staged FLAC files are checked against the port's own decoder
(`native/flac.py::native_available`).

Behavioral parity: reference `DatasetParsers/DatasetDownloader.swift:12-780`:
AMI SDM/IHM audio + annotations/RTTM, musan (mini50/mini100/full), VOiCES
subset, and Earnings22-KWS via the HuggingFace datasets rows API. All network
access routes through the registry's egress gate (`ModelRegistry.offline()`
-> typed `OfflineError`); staging and manifest logic is pure and testable
offline.

Layout under `<cache>/Datasets/<name>/` matches what the benchmark CLI
commands consume:
  ami/<variant>/<meeting>.wav + <meeting>.rttm          (diarization-benchmark)
  musan/{speech,music,noise}/*.wav                      (vad-benchmark)
  voices/*.wav + labels.json                            (vad-benchmark)
  earnings22/<file_id>.wav + <file_id>.txt + keywords.json
                                                        (ctc-earnings-benchmark)
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request
from dataclasses import dataclass
from pathlib import Path

from fluidaudio_tpu_torch.registry.registry import ModelRegistry, OfflineError, RegistryError
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("datasets")

# AMI corpus mirror used by the reference (16 benchmark meetings)
AMI_BASE_URL = "https://groups.inf.ed.ac.uk/ami/AMICorpusMirror/amicorpus"
AMI_BENCHMARK_MEETINGS = (
    "ES2002a", "ES2002b", "ES2002c", "ES2002d",
    "ES2003a", "ES2003b", "ES2003c", "ES2003d",
    "ES2004a", "ES2004b", "ES2004c", "ES2004d",
    "ES2005a", "ES2005b", "ES2005c", "ES2005d",
)
AMI_ANNOTATIONS_URL = (
    "https://groups.inf.ed.ac.uk/ami/AMICorpusAnnotations/ami_public_manual_1.6.2.zip"
)

MUSAN_URL = "https://www.openslr.org/resources/17/musan.tar.gz"
MUSAN_SIZES = {"mini50": 50, "mini100": 100, "full": None}

HF_ROWS_API = "https://datasets-server.huggingface.co/rows"


def datasets_dir() -> Path:
    d = ModelRegistry.cache_dir() / "Datasets"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _gate(name: str, detail: str) -> None:
    if ModelRegistry.offline():
        raise OfflineError(name, detail)


def _fetch(url: str, dest: Path, name: str) -> Path:
    """Download with resume-unfriendly simple fetch + atomic rename."""
    _gate(name, url)
    dest.parent.mkdir(parents=True, exist_ok=True)
    if dest.exists() and dest.stat().st_size > 0:
        return dest
    tmp = dest.with_suffix(dest.suffix + ".part")
    req = urllib.request.Request(url, headers=_headers())
    with urllib.request.urlopen(req, timeout=600) as resp, open(tmp, "wb") as f:
        while True:
            chunk = resp.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
    tmp.rename(dest)
    logger.info("fetched %s -> %s", url, dest)
    return dest


def _headers() -> dict:
    h = {"User-Agent": "fluidaudio-tpu/1.0"}
    token = ModelRegistry.hf_token()
    if token:
        h["Authorization"] = f"Bearer {token}"
    return h


@dataclass
class DatasetDownloader:
    """Stages benchmark datasets into the cache (egress-gated)."""

    root: Path | None = None

    def __post_init__(self):
        self.root = Path(self.root) if self.root else datasets_dir()

    # ------------------------------------------------------------------ AMI
    def download_ami(
        self,
        variant: str = "sdm",
        meetings: tuple[str, ...] = AMI_BENCHMARK_MEETINGS,
    ) -> Path:
        """AMI SDM (single distant mic, Array1-01) or IHM (headset mix) wavs
        + manual-annotation RTTMs (reference DatasetDownloader.swift AMI
        paths)."""
        assert variant in ("sdm", "ihm")
        out = self.root / "ami" / variant
        for meeting in meetings:
            fname = (
                f"{meeting}.Array1-01.wav" if variant == "sdm"
                else f"{meeting}.Mix-Headset.wav"
            )
            url = f"{AMI_BASE_URL}/{meeting}/audio/{fname}"
            _fetch(url, out / f"{meeting}.wav", "ami")
        ann = self.root / "ami" / "annotations.zip"
        if not ann.exists():
            _fetch(AMI_ANNOTATIONS_URL, ann, "ami")
        self.stage_ami_rttms(ann, out, meetings)
        return out

    def stage_ami_rttms(
        self, annotations_zip: Path, out: Path, meetings: tuple[str, ...]
    ) -> list[Path]:
        """Extract per-meeting segment annotations from the AMI manual-
        annotation zip and write RTTM files next to the wavs (pure staging —
        offline-testable; reference AMIParser + RTTM writer)."""
        import xml.etree.ElementTree as ET
        import zipfile

        written: list[Path] = []
        if not annotations_zip.exists():
            return written
        with zipfile.ZipFile(annotations_zip) as zf:
            names = zf.namelist()
            for meeting in meetings:
                segs: list[tuple[float, float, str]] = []
                for n in names:
                    # segments/<meeting>.<speaker>.segments.xml
                    base = n.rsplit("/", 1)[-1]
                    if not (base.startswith(meeting + ".")
                            and base.endswith(".segments.xml")):
                        continue
                    speaker = base.split(".")[1]
                    root = ET.fromstring(zf.read(n))
                    for seg in root.iter("segment"):
                        try:
                            s = float(seg.attrib["transcriber_start"])
                            e = float(seg.attrib["transcriber_end"])
                        except (KeyError, ValueError):
                            continue
                        if e > s:
                            segs.append((s, e - s, speaker))
                if not segs:
                    continue
                segs.sort()
                rttm = out / f"{meeting}.rttm"
                rttm.parent.mkdir(parents=True, exist_ok=True)
                with open(rttm, "w") as f:
                    for s, dur, spk in segs:
                        f.write(
                            f"SPEAKER {meeting} 1 {s:.3f} {dur:.3f} "
                            f"<NA> <NA> {spk} <NA> <NA>\n"
                        )
                written.append(rttm)
        return written

    # ---------------------------------------------------------------- musan
    def download_musan(self, size: str = "mini50") -> Path:
        """musan noise/speech/music corpus; mini50/mini100 keep the first N
        files per category after extraction (reference musan mini sets)."""
        assert size in MUSAN_SIZES
        out = self.root / "musan"
        tarball = out / "musan.tar.gz"
        _fetch(MUSAN_URL, tarball, "musan")
        self.stage_musan(tarball, out, MUSAN_SIZES[size])
        return out

    def stage_musan(self, tarball: Path, out: Path, per_category: int | None) -> int:
        """Extract up to per_category wavs per category (pure staging)."""
        import tarfile

        if not tarball.exists():
            return 0
        counts: dict[str, int] = {}
        n = 0
        with tarfile.open(tarball, "r:gz") as tf:
            for member in tf:
                parts = Path(member.name).parts
                if len(parts) < 3 or not member.name.endswith(".wav"):
                    continue
                category = parts[1]  # musan/{music,noise,speech}/...
                if per_category is not None and counts.get(category, 0) >= per_category:
                    continue
                dest = out / category / Path(member.name).name
                if not dest.exists():
                    dest.parent.mkdir(parents=True, exist_ok=True)
                    src = tf.extractfile(member)
                    if src is None:
                        continue
                    dest.write_bytes(src.read())
                counts[category] = counts.get(category, 0) + 1
                n += 1
        return n

    # ----------------------------------------------------- HF rows API sets
    def fetch_hf_rows(
        self, dataset: str, config: str, split: str, offset: int = 0,
        length: int = 100,
    ) -> list[dict]:
        """One page of the HF datasets rows API (reference Earnings22/VOiCES
        path, `DatasetDownloader.swift` rows-API loader)."""
        _gate(dataset, f"rows {split}[{offset}:{offset + length}]")
        q = urllib.parse.urlencode({
            "dataset": dataset, "config": config, "split": split,
            "offset": offset, "length": length,
        })
        req = urllib.request.Request(f"{HF_ROWS_API}?{q}", headers=_headers())
        with urllib.request.urlopen(req, timeout=120) as resp:
            payload = json.loads(resp.read().decode())
        return payload.get("rows", [])

    def download_earnings22_kws(self, max_files: int = 10) -> Path:
        """Earnings22 keyword-spotting subset via the HF rows API: audio +
        transcript + keyword list per file."""
        out = self.root / "earnings22"
        rows = self.fetch_hf_rows(
            "distil-whisper/earnings22", "full", "test", length=max_files
        )
        self.stage_hf_rows(rows, out)
        return out

    def download_voices_subset(self, max_files: int = 50) -> Path:
        """VOiCES subset rows (audio + clean/noisy labels) for VAD."""
        out = self.root / "voices"
        rows = self.fetch_hf_rows(
            "Lichang-Chen/VOiCES-subset", "default", "train", length=max_files
        )
        self.stage_hf_rows(rows, out)
        return out

    # -------------------------------------------------- ASR corpora (HF)
    def download_librispeech(self, subset: str = "test-clean") -> Path:
        """LibriSpeech subset tarball from the reference's mirror
        (`AsrBenchmark.swift:52-58`: FluidInference/librispeech
        test-clean.tar.gz). Extracted into the standard LibriSpeech layout
        the asr-benchmark command consumes. Audio inside the upstream
        openslr tars is FLAC; staged .flac files decode natively via
        `native/flac` (when the library is built) straight onto the int16
        device-transfer path."""
        import tarfile

        out = self.root / "LibriSpeech"
        url = ("https://huggingface.co/datasets/FluidInference/librispeech"
               f"/resolve/main/{subset}.tar.gz")
        tarball = _fetch(url, self.root / f"librispeech-{subset}.tar.gz",
                         "librispeech")
        with tarfile.open(tarball, "r:gz") as tf:
            # filter='data' rejects path traversal / absolute members from a
            # compromised mirror tarball (and silences the 3.12 deprecation)
            tf.extractall(self.root, filter="data")
        staged = out / subset
        if not staged.is_dir():
            # tarballs differing in root dir: find the subset dir
            hits = list(self.root.rglob(f"{subset}/*/*/*.trans.txt"))
            staged = hits[0].parents[2] if hits else out
        flacs = list(staged.rglob("*.flac"))
        if flacs:
            from fluidaudio_tpu_torch.native.flac import native_available

            if native_available():
                logger.info("%d FLAC files staged (native decoder available)",
                            len(flacs))
            else:
                logger.warning(
                    "%d FLAC files staged but the FLAC decoder could not be "
                    "built (native/flac/flac.cpp); convert to wav first", len(flacs))
        return staged

    def download_fleurs(self, languages: str = "es_419,fr_fr,de_de") -> Path:
        """FLEURS per-language test sets from the reference's mirror
        (`MultilingualBenchmarkDataset.swift:37`: FluidInference/fleurs-full)
        staged into the `<lang>/test.tsv` + wavs layout the fleurs-benchmark
        and nemotron-multilingual-benchmark commands parse."""
        from fluidaudio_tpu_torch.registry.download import DownloadUtils

        out = self.root / "fleurs"
        repo = "FluidInference/fleurs-full"
        for lang in [l.strip() for l in languages.split(",") if l.strip()]:
            lang_dir = out / lang
            tsv = DownloadUtils.fetch_hf_file(
                repo, f"{lang}/test.tsv", out, dataset=True)
            for line in tsv.read_text().splitlines():
                cols = line.split("\t")
                if len(cols) < 3:
                    continue
                fname = cols[1]
                for remote in (f"{lang}/audio/test/{fname}",
                               f"{lang}/test/{fname}", f"{lang}/{fname}"):
                    try:
                        DownloadUtils.fetch_hf_file(repo, remote, out,
                                                    dataset=True)
                        break
                    except Exception:
                        continue
            if not (lang_dir / "test.tsv").exists():
                raise RegistryError(
                    f"fleurs staging produced no test.tsv for {lang!r} "
                    f"(checked {lang_dir}); the remote layout may differ — "
                    "inspect the repo tree and adjust download_fleurs"
                )
        return out

    def download_jsut(self, max_files: int = 0) -> Path:
        """JSUT basic5000 from the reference's mirror
        (`JapaneseDatasetDownloader.swift:41-77`:
        FluidInference/JSUT-basic5000, `basic5000/transcript_utf8.txt` +
        `basic5000/wav/<id>.wav`), staged into LibriSpeech layout so the
        ja-benchmark CER harness consumes it directly."""
        from fluidaudio_tpu_torch.registry.download import DownloadUtils

        repo = "FluidInference/JSUT-basic5000"
        out = self.root / "jsut" / "basic5000" / "1"
        out.mkdir(parents=True, exist_ok=True)
        transcript = DownloadUtils.fetch_hf_file(
            repo, "basic5000/transcript_utf8.txt", self.root / "jsut",
            dataset=True)
        lines = []
        n = 0
        for line in transcript.read_text(encoding="utf-8").splitlines():
            utt, _, text = line.partition(":")
            utt, text = utt.strip(), text.strip()
            if not utt or not text:
                continue
            DownloadUtils.fetch_hf_file(
                repo, f"basic5000/wav/{utt}.wav", self.root / "jsut",
                dataset=True)
            src = self.root / "jsut" / "basic5000" / "wav" / f"{utt}.wav"
            if src.exists():
                (out / f"{utt}.wav").write_bytes(src.read_bytes())
            lines.append(f"{utt} {text}")
            n += 1
            if max_files and n >= max_files:
                break
        (out / "basic5000-1.trans.txt").write_text("\n".join(lines),
                                                   encoding="utf-8")
        return out.parent.parent

    def stage_hf_rows(self, rows: list[dict], out: Path) -> int:
        """Materialize rows-API rows: audio URLs are fetched, text columns
        written next to them, everything else into labels.json (pure given
        pre-fetched row dicts — offline-testable)."""
        out.mkdir(parents=True, exist_ok=True)
        labels: dict[str, dict] = {}
        n = 0
        for i, entry in enumerate(rows):
            row = entry.get("row", entry)
            file_id = str(row.get("id", row.get("file_id", i)))
            meta: dict = {}
            for key, value in row.items():
                if isinstance(value, list) and value and isinstance(value[0], dict) \
                        and "src" in value[0]:
                    # audio column: [{"src": url, "type": "audio/wav"}]
                    _fetch(value[0]["src"], out / f"{file_id}.wav", "hf-rows")
                elif isinstance(value, dict) and "src" in value:
                    _fetch(value["src"], out / f"{file_id}.wav", "hf-rows")
                elif key in ("text", "transcript", "transcription", "sentence"):
                    (out / f"{file_id}.txt").write_text(str(value))
                else:
                    meta[key] = value
            labels[file_id] = meta
            n += 1
        (out / "labels.json").write_text(json.dumps(labels, indent=1))
        return n
