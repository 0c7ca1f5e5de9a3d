"""Supertonic3Manager: 31-language 44.1 kHz TTS (step-fed flow matching), in PyTorch.

Port of `fluidaudio_tpu/tts/supertonic_manager.py` (reference
`Supertonic3/Supertonic3Manager.swift:36`, `Supertonic3Synthesizer.swift:
33-216`): the UnicodeProcessor normalisation, the chunker, the unicode
indexer and the voice styles are copies of JAX's host code.

Per chunk on `device` (None = the GPU): the duration predictor runs and its
duration comes back (one copy) for the host's speed scaling and latent
length; the text encoder runs; the noisy latent is drawn on the host with
numpy `RandomState(seed)` exactly as in JAX (`sample_noisy_latent`) and goes
up with its mask; the `total_steps` estimator steps run back to back on the
device (`denoise`, JAX's unrolled loop); the vocoder runs and the samples
come back (one copy), trimmed to the duration.

Weights: `checkpoint_dir` holds `{text_encoder,duration_predictor,
vector_estimator,vocoder}.npz` (converted; the JAX package's
`convert/supertonic3.py` turns a staged ONNX release into them);
`checkpoint_dir=None` reads the model cache's `Repo.SUPERTONIC3` folder;
without them the weights are seeded random, drawn on `device`.
"""

from __future__ import annotations

import json
import re
import unicodedata
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from fluidaudio_tpu_torch.models.supertonic3 import (
    DEFAULT_TOTAL_STEPS,
    DP_STYLE_DIM,
    DP_STYLE_TOKENS,
    SAMPLE_RATE,
    SAMPLES_PER_LATENT,
    SUPERTONIC3_BASE,
    TTL_STYLE_DIM,
    TTL_STYLE_TOKENS,
    Supertonic3Config,
    Supertonic3DurationPredictor,
    Supertonic3TextEncoder,
    Supertonic3VectorEstimator,
    Supertonic3Vocoder,
    random_init_supertonic3_,
    sample_noisy_latent,
)
from fluidaudio_tpu_torch.models.zoo import disable_tf32
from fluidaudio_tpu_torch.registry import DownloadUtils, Repo
from fluidaudio_tpu_torch.utils.device import resolve_device
from fluidaudio_tpu_torch.utils.logging import get_logger
from fluidaudio_tpu_torch.utils.weights import load_npz, load_state

logger = get_logger("tts.supertonic3")

AVAILABLE_LANGUAGES = {
    "en", "ko", "ja", "ar", "bg", "cs", "da", "de", "el", "es", "et", "fi",
    "fr", "hi", "hr", "hu", "id", "it", "lt", "lv", "nl", "pl", "pt", "ro",
    "ru", "sk", "sl", "sv", "tr", "uk", "vi", "na",
}
CJK_LANGUAGES = {"ko", "ja"}
MAX_CHUNK_LATIN = 70
MAX_CHUNK_CJK = 57
DEFAULT_SPEED = 1.05
DEFAULT_SILENCE_S = 0.05

# The 10 built-in voice styles published at
# FluidInference/supertonic-3-coreml/voice_styles/ (Supertonic3Types.swift:
# 120-150): female F1-F5, male M1-M5; M1 shipped first and is the default.
SUPERTONIC3_VOICES = ("F1", "F2", "F3", "F4", "F5", "M1", "M2", "M3", "M4", "M5")
DEFAULT_VOICE = "M1"


def parse_voice(name: str) -> str | None:
    """Case-insensitive voice-name parse; None for unknown names so callers
    (e.g. a CLI passing a Kokoro-style voice id) can fall back to the
    default (`Supertonic3Voice.init?(name:)`)."""
    up = name.upper()
    return up if up in SUPERTONIC3_VOICES else None


def voice_style_filename(name: str) -> str:
    """Repo-relative style JSON path, e.g. `voice_styles/F3.json`."""
    return f"voice_styles/{name}.json"


def load_voice_style(path: str | Path) -> dict[str, np.ndarray]:
    """Decode a voice style JSON (`Supertonic3VoiceStyle.load`):
    {"style_ttl": {data, dims, type}, "style_dp": {...}} with dims validated
    against the model contract; returns {"ttl": [50,256], "dp": [8,16]}."""
    path = Path(path)
    try:
        raw = json.loads(path.read_text())
    except (OSError, ValueError) as e:
        raise ValueError(f"voice style load failed: {path}: {e}") from e
    out = {}
    for key, short, dims in (
        ("style_ttl", "ttl", [1, TTL_STYLE_TOKENS, TTL_STYLE_DIM]),
        ("style_dp", "dp", [1, DP_STYLE_TOKENS, DP_STYLE_DIM]),
    ):
        comp = raw.get(key)
        if comp is None:
            raise ValueError(f"voice style {path.name} missing {key}")
        if list(comp.get("dims", [])) != dims:
            raise ValueError(
                f"voice style shape mismatch for {key}: "
                f"expected {dims}, got {comp.get('dims')}"
            )
        out[short] = np.asarray(comp["data"], np.float32).reshape(dims[1], dims[2])
    return out

_SYMBOL_REPLACEMENTS = [
    ("–", "-"), ("‑", "-"), ("—", "-"), ("_", " "),
    ("“", '"'), ("”", '"'), ("‘", "'"), ("’", "'"),
    ("´", "'"), ("`", "'"), ("[", " "), ("]", " "), ("|", " "),
    ("/", " "), ("#", " "), ("→", " "), ("←", " "),
]
_DECORATIVE = ["♥", "☆", "♡", "©", "\\"]
_EXPRESSIONS = [("@", " at "), ("e.g.,", "for example, "), ("i.e.,", "that is, ")]
_EMOJI_RANGES = (
    (0x1F600, 0x1F64F), (0x1F300, 0x1F5FF), (0x1F680, 0x1F6FF),
    (0x1F700, 0x1F77F), (0x1F780, 0x1F7FF), (0x1F800, 0x1F8FF),
    (0x1F900, 0x1F9FF), (0x1FA00, 0x1FA6F), (0x1FA70, 0x1FAFF),
    (0x2600, 0x26FF), (0x2700, 0x27BF), (0x1F1E6, 0x1F1FF),
)
_SENT_END = re.compile(
    "[.!?;:,'\"“”‘’)\\]}…。」』】〉》›»]$"
)


def preprocess_text(raw: str, lang: str) -> str:
    """`Supertonic3UnicodeProcessor.preprocess` parity."""
    text = unicodedata.normalize("NFKD", raw)
    text = "".join(
        c for c in text
        if not any(lo <= ord(c) <= hi for lo, hi in _EMOJI_RANGES)
    )
    for old, new in _SYMBOL_REPLACEMENTS:
        text = text.replace(old, new)
    for sym in _DECORATIVE:
        text = text.replace(sym, "")
    for old, new in _EXPRESSIONS:
        text = text.replace(old, new)
    for old in (" ,", " .", " !", " ?", " ;", " :", " '"):
        text = text.replace(old, old[1:])
    for rep, single in (('""', '"'), ("''", "'"), ("``", "`")):
        while rep in text:
            text = text.replace(rep, single)
    text = re.sub(r"\s+", " ", text).strip()
    if text and not _SENT_END.search(text):
        text += "."
    return f"<{lang}>{text}</{lang}>"


# sentence terminators that are actually abbreviations — do not split after
# (reference `Supertonic3TextChunker.abbreviations`)
_ABBREVIATIONS = (
    "Dr.", "Mr.", "Mrs.", "Ms.", "Prof.", "Sr.", "Jr.",
    "St.", "Ave.", "Rd.", "Blvd.", "Dept.", "Inc.", "Ltd.",
    "Co.", "Corp.", "etc.", "vs.", "i.e.", "e.g.", "Ph.D.",
)


def _split_sentences(text: str) -> list[str]:
    """Abbreviation-aware sentence split on `[.!?]` + whitespace."""
    sentences: list[str] = []
    last = 0
    for m in re.finditer(r"[.!?]\s+", text):
        combined = text[last : m.start() + 1].strip()
        if any(combined.endswith(a) for a in _ABBREVIATIONS):
            continue
        sentences.append(text[last : m.end()])
        last = m.end()
    if last < len(text):
        sentences.append(text[last:])
    return sentences or [text]


def _pack(parts: list[str], max_chars: int, sep: str, overflow) -> list[str]:
    """Greedy packing of `parts` into chunks <= max_chars, recursing into
    `overflow` for parts that alone exceed the cap."""
    chunks: list[str] = []
    cur = ""
    for part in parts:
        part = part.strip()
        if not part:
            continue
        if len(part) > max_chars:
            if cur:
                chunks.append(cur)
                cur = ""
            chunks.extend(overflow(part))
            continue
        if cur and len(cur) + len(part) + len(sep) > max_chars:
            chunks.append(cur)
            cur = ""
        cur = part if not cur else f"{cur}{sep}{part}"
    if cur:
        chunks.append(cur)
    return chunks


def chunk_text(text: str, max_chars: int) -> list[str]:
    """`Supertonic3TextChunker.chunk` parity (upstream `Helper.chunkText`):
    split on blank-line paragraph boundaries first (each short paragraph is
    its own chunk), then pack abbreviation-aware sentences, falling back to
    comma boundaries and finally whitespace so no chunk ever exceeds
    `max_chars` — text past the encoder's fixed char buffer would otherwise
    be silently dropped."""
    text = text.strip()
    if not text:
        return []

    def pack_words(phrase: str) -> list[str]:
        out, cur = [], ""
        for w in phrase.split():
            if len(w) > max_chars:  # single over-long word: hard cut
                if cur:
                    out.append(cur)
                    cur = ""
                out.extend(w[i : i + max_chars] for i in range(0, len(w), max_chars))
                continue
            if cur and len(cur) + len(w) + 1 > max_chars:
                out.append(cur)
                cur = ""
            cur = w if not cur else f"{cur} {w}"
        if cur:
            out.append(cur)
        return out

    def pack_commas(sentence: str) -> list[str]:
        return _pack(sentence.split(","), max_chars, ", ", pack_words)

    chunks: list[str] = []
    for para in re.split(r"\n\s*\n", text):
        para = para.strip()
        if not para:
            continue
        if len(para) <= max_chars:
            chunks.append(para)
            continue
        chunks.extend(_pack(_split_sentences(para), max_chars, " ", pack_commas))
    return chunks


class UnicodeIndexer:
    """unicode_indexer.json: flat codepoint -> id list; -1 for unknown.

    Without the downloaded asset a deterministic fallback maps codepoints
    into the configured vocab (stable across runs; replaced verbatim once
    the real indexer is cached)."""

    def __init__(self, table: list[int] | None, vocab_size: int):
        self.table = table
        self.vocab_size = vocab_size

    def encode(self, text: str, max_len: int) -> tuple[np.ndarray, int]:
        ids = np.zeros((max_len,), np.int64)
        n = min(len(text), max_len)
        for j, ch in enumerate(text[:max_len]):
            cp = ord(ch)
            if self.table is not None:
                ids[j] = self.table[cp] if cp < len(self.table) else -1
            else:
                ids[j] = 1 + (cp % (self.vocab_size - 2))
        return ids, n


@dataclass
class Supertonic3Result:
    samples: np.ndarray
    sample_rate: int
    duration: float


class Supertonic3Manager:
    def __init__(
        self,
        config: Supertonic3Config | None = None,
        *,
        checkpoint_dir: str | Path | None = None,
        rng_seed: int = 0,
        total_steps: int = DEFAULT_TOTAL_STEPS,
        device: torch.device | str | None = None,
    ):
        self.cfg = cfg = config or SUPERTONIC3_BASE
        self.total_steps = total_steps
        self.device = dev = resolve_device(device)
        disable_tf32()
        self.text_enc = Supertonic3TextEncoder(cfg, device=dev).eval()
        self.dur_pred = Supertonic3DurationPredictor(cfg, device=dev).eval()
        self.estimator = Supertonic3VectorEstimator(cfg, device=dev).eval()
        self.vocoder = Supertonic3Vocoder(cfg, device=dev).eval()
        gen = torch.Generator(device=dev).manual_seed(rng_seed)
        base = Path(checkpoint_dir) if checkpoint_dir else DownloadUtils.repo_dir(Repo.SUPERTONIC3)
        for part, module in (("text_encoder", self.text_enc), ("duration_predictor", self.dur_pred),
                             ("vector_estimator", self.estimator), ("vocoder", self.vocoder)):
            random_init_supertonic3_(module, gen)
            f = base / f"{part}.npz"
            if f.exists():
                load_state(module, load_npz(f))
        self.indexer = self._load_indexer(base)
        self.voices = self._load_voices(base)

    @torch.no_grad()
    def denoise(self, z: torch.Tensor, text_emb: torch.Tensor, style_ttl: torch.Tensor,
                latent_mask: torch.Tensor, text_mask: torch.Tensor, steps: int) -> torch.Tensor:
        """`steps` estimator steps back to back on the device (JAX's unrolled
        loop), each fed the last one's output; no host read."""
        total = torch.full((z.shape[0],), float(steps), device=z.device)
        for step in range(steps):
            cur = torch.full((z.shape[0],), float(step), device=z.device)
            z = self.estimator(z, text_emb, style_ttl, latent_mask, text_mask, cur, total)
        return z

    # ---------------------------------------------------------------- assets

    def _load_indexer(self, base: Path) -> UnicodeIndexer:
        f = base / "unicode_indexer.json"
        if f.exists():
            return UnicodeIndexer(json.loads(f.read_text()), self.cfg.vocab_size)
        return UnicodeIndexer(None, self.cfg.vocab_size)

    def _load_voices(self, base: Path) -> dict[str, dict[str, np.ndarray]]:
        """Voice styles keyed by canonical name: the release layout
        `voice_styles/{NAME}.json`, then a legacy combined `voices.json`,
        then a seeded random catalog over the full 10-voice set."""
        styles_dir = base / "voice_styles"
        if styles_dir.is_dir():
            loaded = {}
            for name in SUPERTONIC3_VOICES:
                f = styles_dir / f"{name}.json"
                if f.exists():
                    loaded[name] = load_voice_style(f)
            if loaded:
                return loaded
        f = base / "voices.json"
        if f.exists():
            raw = json.loads(f.read_text())
            return {
                k: {"ttl": np.asarray(v["ttl"], np.float32).reshape(
                        TTL_STYLE_TOKENS, TTL_STYLE_DIM),
                    "dp": np.asarray(v["dp"], np.float32).reshape(
                        DP_STYLE_TOKENS, DP_STYLE_DIM)}
                for k, v in raw.items()
            }
        rng = np.random.RandomState(11)
        return {
            name: {"ttl": rng.randn(TTL_STYLE_TOKENS, TTL_STYLE_DIM).astype(np.float32) * 0.1,
                   "dp": rng.randn(DP_STYLE_TOKENS, DP_STYLE_DIM).astype(np.float32) * 0.1}
            for name in SUPERTONIC3_VOICES
        }

    @property
    def available_voices(self) -> list[str]:
        return sorted(self.voices)

    # ------------------------------------------------------------------- api

    def synthesize(
        self,
        text: str,
        voice: str = DEFAULT_VOICE,
        language: str = "en",
        *,
        speed: float = DEFAULT_SPEED,
        total_steps: int | None = None,
        silence_duration: float = DEFAULT_SILENCE_S,
        seed: int = 0,
    ) -> Supertonic3Result:
        if language not in AVAILABLE_LANGUAGES:
            raise ValueError(f"unsupported language {language!r}")
        # exact key first (custom styles keep their case), then the
        # case-insensitive built-in parse (Supertonic3Voice.init?(name:))
        style = self.voices.get(voice)
        if style is None:
            canonical = parse_voice(voice)
            if canonical is not None:
                style = self.voices.get(canonical)
        if style is None:
            raise KeyError(f"unknown voice {voice!r}; available {self.available_voices}")
        max_len = MAX_CHUNK_CJK if language in CJK_LANGUAGES else MAX_CHUNK_LATIN
        chunks = chunk_text(text, max_len)
        if not chunks:
            raise ValueError("empty text")

        silence = np.zeros(max(0, int(silence_duration * SAMPLE_RATE)), np.float32)
        pieces: list[np.ndarray] = []
        duration_total = 0.0
        for ci, chunk in enumerate(chunks):
            samples, dur = self._infer(chunk, language, style, speed, seed + ci,
                                       total_steps or self.total_steps)
            if ci:
                pieces.append(silence)
                duration_total += silence_duration
            pieces.append(samples)
            duration_total += dur
        return Supertonic3Result(
            samples=np.concatenate(pieces), sample_rate=SAMPLE_RATE,
            duration=duration_total,
        )

    def _infer(self, chunk: str, language: str, style, speed: float,
               seed: int, steps: int | None = None):
        cfg = self.cfg
        dev = self.device
        ids, n = self.indexer.encode(preprocess_text(chunk, language), cfg.text_t)
        tokens = torch.as_tensor(ids[None]).to(dev)
        tmask = torch.as_tensor((np.arange(cfg.text_t) < n).astype(np.float32)[None]).to(dev)
        ttl = torch.as_tensor(style["ttl"][None]).to(dev)
        dp = torch.as_tensor(style["dp"][None]).to(dev)

        dur = float(self.dur_pred(tokens, tmask, dp)[0].cpu())
        dur = max(0.05, dur / max(speed, 0.05))
        # cap to the latent bucket
        dur = min(dur, cfg.max_latent * SAMPLES_PER_LATENT / SAMPLE_RATE)

        text_emb = self.text_enc(tokens, tmask, ttl)
        z, lmask, _ = sample_noisy_latent(np.array([dur]), cfg.max_latent,
                                          np.random.RandomState(seed))
        z = self.denoise(torch.as_tensor(z).to(dev), text_emb, ttl,
                         torch.as_tensor(lmask).to(dev), tmask[:, None, :],
                         steps or self.total_steps)
        wav = self.vocoder(z)[0].cpu().numpy()
        trim = min(wav.size, int(SAMPLE_RATE * dur))
        return (wav[:trim] if trim else wav), dur
