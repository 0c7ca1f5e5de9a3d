"""Nemotron streaming ASR (en 0.6B + multilingual), cache-aware RNN-T, in PyTorch.

Port of `fluidaudio_tpu/asr/streaming_nemotron.py`: chunk tiers
560/1120/2240 ms, the cache-aware conformer, greedy RNN-T; the multilingual
packs add a per-language `prompt_id` that conditions the encoder (an
additive prompt embedding), latin (2,828) or full (13,087) vocabularies, an
auto-detect mode, `<xx-XX>` language-tag tokens filtered from the text (the
first one is the detected language) and forced-prefix decoding.

Shares the chunk loop of the EOU manager (`streaming_eou`): each chunk runs
on the device with every cache carried there and makes one device->host
copy. `checkpoint_dir=None` means seeded random weights (with a warning):
the registry download cache is not ported; the spec keeps its registry
folder name as a string.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

from fluidaudio_tpu_torch.asr.streaming_eou import (
    EouPartialResult,
    _StreamingManagerBase,
    _StreamState,
)
from fluidaudio_tpu_torch.models.conformer_streaming import (
    StreamingCaches,
    StreamingConformerConfig,
    StreamingConformerEncoder,
)
from fluidaudio_tpu_torch.ops.tdt_decode import TdtDecodeConfig

NEMOTRON_TIERS_MS = (560, 1120, 2240)

# fallback multilingual locale -> prompt id table (0 = auto-detect); the
# real mapping ships in the model's metadata.json (prompt_dictionary)
NEMOTRON_LOCALES = {
    loc: i
    for i, loc in enumerate(
        ["auto", "en", "es", "fr", "it", "pt", "de", "nl", "pl", "ru", "uk", "cs",
         "ro", "hu", "sv", "da", "no", "fi", "tr", "ar", "he", "hi", "zh", "ja",
         "ko", "vi", "th", "id", "ms"]
    )
}


@dataclass
class NemotronMultilingualMetadata:
    """Operational config from the multilingual pack's metadata.json: the
    prompt-id dictionary, the auto-detect default (101), the prompt-table
    size (128) and the `<xx-XX>` language-tag token ids the model emits
    (filtered from transcripts; the first one = detected language)."""

    num_prompts: int = 128
    default_prompt_id: int = 101
    prompt_dictionary: dict | None = None
    lang_tag_token_ids: frozenset = frozenset()

    def __post_init__(self):
        if self.prompt_dictionary is None:
            self.prompt_dictionary = {"auto": self.default_prompt_id}

    @classmethod
    def load(cls, path):
        """Parse metadata.json. Unreadable/invalid JSON and a non-object
        root RAISE; missing or wrong-typed keys fall back to defaults."""
        meta = json.loads(Path(path).read_text())
        if not isinstance(meta, dict):
            raise ValueError(f"{path}: metadata root must be a JSON object")

        def _int(key: str, default: int) -> int:
            v = meta.get(key)
            return v if isinstance(v, int) and not isinstance(v, bool) else default

        pd = meta.get("prompt_dictionary")
        tags = meta.get("lang_tag_token_ids")
        return cls(
            num_prompts=_int("num_prompts", 128),
            default_prompt_id=_int("default_prompt_id", 101),
            prompt_dictionary=(
                {k: v for k, v in pd.items() if isinstance(v, int)}
                if isinstance(pd, dict) else {"auto": 101}
            ),
            lang_tag_token_ids=(
                frozenset(t for t in tags if isinstance(t, int))
                if isinstance(tags, list) else frozenset()
            ),
        )

    def prompt_id(self, language: str | None) -> int:
        """Resolve a language code to a prompt id: exact -> underscore->dash
        -> xx-XX casing -> bare-prefix match -> default."""
        if not language:
            return self.default_prompt_id
        d = self.prompt_dictionary
        if language in d:
            return d[language]
        dashed = language.replace("_", "-")
        if dashed in d:
            return d[dashed]
        if "-" in dashed:
            lang, _, region = dashed.partition("-")
            cased = f"{lang.lower()}-{region.upper()}"
            if cased in d:
                return d[cased]
        prefix = dashed.split("-")[0].lower()
        for key, pid in d.items():
            if key.split("-")[0].lower() == prefix:
                return pid
        return self.default_prompt_id


@dataclass(frozen=True)
class NemotronSpec:
    name: str
    repo: str  # registry folder name (resolved by a later slice)
    vocab_size: int  # excludes blank
    d_model: int = 1024
    n_layers: int = 24
    multilingual: bool = False
    pred_hidden: int = 640
    joint_hidden: int = 640


NEMOTRON_EN = NemotronSpec("nemotron-en", "nemotron-en", vocab_size=1024)
NEMOTRON_MULTI_LATIN = NemotronSpec(
    "nemotron-multilingual-latin", "nemotron-multilingual", vocab_size=2828,
    multilingual=True,
)
NEMOTRON_MULTI_FULL = NemotronSpec(
    "nemotron-multilingual", "nemotron-multilingual", vocab_size=13087,
    multilingual=True,
)
#: hermetic trained-fixture spec: two synthetic "languages" (pure-tone
#: w-words ids 0-15 / harmonic v-words ids 16-31), lang tags <aa-AA>=32
#: <bb-BB>=33, blank 34; prompts {auto:0, aa:1, bb:2}
NEMOTRON_TEST = NemotronSpec(
    "nemotron-test", "nemotron-multilingual", vocab_size=34,
    d_model=64, n_layers=2, multilingual=True,
    pred_hidden=64, joint_hidden=64,
)


class _PromptedEncoder(nn.Module):
    """Streaming conformer + additive per-language prompt conditioning
    (`encoder.*` and `prompt_embed` in the flax tree)."""

    def __init__(self, cfg: StreamingConformerConfig, n_prompts: int, device=None):
        super().__init__()
        self.encoder = StreamingConformerEncoder(cfg, device)
        self.n_prompts = n_prompts
        if n_prompts > 0:
            self.prompt_embed = nn.Parameter(
                torch.zeros(n_prompts, cfg.d_model, dtype=torch.float32, device=device))

    @torch.no_grad()
    def forward(self, mel_chunk: torch.Tensor, caches: StreamingCaches,
                prompt_id: torch.Tensor) -> tuple[torch.Tensor, StreamingCaches]:
        x, new_caches = self.encoder(mel_chunk, caches)  # x is f32
        if self.n_prompts > 0:
            x = x + self.prompt_embed[prompt_id.long()][:, None, :].to(x.dtype)
        return x, new_caches


def fleurs_to_multilingual_language(fleurs_code: str) -> str:
    """FLEURS locale (e.g. `en_us`) -> the multilingual pack's prompt-key
    format (`en-US`), with the reference's special cases. Unknown shapes
    pass through and fall back to the default prompt."""
    special = {"cmn_hans_cn": "zh-CN", "es_419": "es-ES",
               "pt_br": "pt-BR", "ar_eg": "ar-EG"}
    if fleurs_code in special:
        return special[fleurs_code]
    parts = fleurs_code.split("_")
    if len(parts) == 2:
        return f"{parts[0]}-{parts[1].upper()}"
    return fleurs_code


class StreamingNemotronAsrManager(_StreamingManagerBase):
    def __init__(
        self,
        spec: NemotronSpec = NEMOTRON_EN,
        chunk_ms: int = 2240,
        *,
        language: str = "auto",
        enc_cfg: StreamingConformerConfig | None = None,
        checkpoint_dir: str | Path | None = None,
        rng_seed: int = 0,
        on_partial: Callable[[EouPartialResult], None] | None = None,
        device: torch.device | str | None = None,
    ):
        """`device=None` is the GPU (RuntimeError without one); pass "cpu"
        to run on the CPU. `checkpoint_dir=None`: seeded random weights."""
        if chunk_ms not in NEMOTRON_TIERS_MS:
            raise ValueError(f"chunk_ms must be one of {NEMOTRON_TIERS_MS}, got {chunk_ms}")
        self.spec = spec
        self.chunk_ms = chunk_ms
        self.on_partial = on_partial
        self.language = language
        self.enc_cfg = enc_cfg or StreamingConformerConfig(
            d_model=spec.d_model, n_layers=spec.n_layers
        )
        # resolve the asset folder + metadata FIRST: the prompt-embedding
        # table is sized from metadata.num_prompts
        self._ckpt_base = self._resolve_base(checkpoint_dir)
        self.metadata = self._load_metadata(self._ckpt_base)
        self._build(
            _PromptedEncoder(self.enc_cfg,
                             self.metadata.num_prompts if spec.multilingual else 0),
            spec.vocab_size, spec.pred_hidden, spec.joint_hidden,
            TdtDecodeConfig(blank_id=spec.vocab_size, durations=(), max_symbols_per_step=10,
                            max_tokens=256),
            device,
        )
        self._load_weights(self._ckpt_base, rng_seed, f"{spec.name} ({spec.repo})",
                           spec.vocab_size)
        self.prompt_id = (
            self.metadata.prompt_id(None if language == "auto" else language)
            if spec.multilingual else 0
        )
        self.detected_language: str | None = None

    def _resolve_base(self, checkpoint_dir) -> Path | None:
        """Per-tier (and per-language for multilingual) asset subfolders of
        `checkpoint_dir`; None without one."""
        if not checkpoint_dir:
            return None
        root = Path(checkpoint_dir)
        candidates = [root / f"{self.chunk_ms}ms", root]
        if self.spec.multilingual and self.language not in ("auto", ""):
            lang_key = self.language.replace("_", "-").split("-")[0].lower()
            candidates = [root / lang_key / f"{self.chunk_ms}ms",
                          root / lang_key] + candidates
        return next(
            (c for c in candidates if (c / "encoder.npz").exists()), candidates[-1]
        )

    def _load_metadata(self, base: Path | None) -> NemotronMultilingualMetadata:
        if not self.spec.multilingual:
            return NemotronMultilingualMetadata(num_prompts=0, default_prompt_id=0)
        if base is not None and (base / "metadata.json").exists():
            return NemotronMultilingualMetadata.load(base / "metadata.json")
        # no metadata asset: fall back to the built-in locale table
        return NemotronMultilingualMetadata(
            num_prompts=128,
            default_prompt_id=NEMOTRON_LOCALES["auto"],
            prompt_dictionary=dict(NEMOTRON_LOCALES),
        )

    def set_language(self, language: str | None) -> None:
        """Switch the encoder's prompt conditioning between utterances. The
        prompt id is a tensor argument of the chunk step, so this is pure
        data; unknown codes fall back to the metadata's default prompt."""
        self.language = language or "auto"
        self.prompt_id = (
            self.metadata.prompt_id(None if self.language == "auto" else self.language)
            if self.spec.multilingual else 0
        )
        self.detected_language = None

    def lang_tag_token(self, language: str) -> int | None:
        """Vocab id of the `<xx-XX>` language-tag piece, if the pack has one
        (used by forced-prefix decoding, the hard language lock)."""
        code = (language or "").replace("_", "-")
        if "-" in code:
            lang, _, region = code.partition("-")
            code = f"{lang.lower()}-{region.upper()}"
        p2i = self.tokenizer._piece_to_id
        for cand in (f"<{code}>", f"<{code.split('-')[0].lower()}>"):
            if cand in p2i:
                return p2i[cand]
        return None

    def make_multi_state(self, n_streams: int, *,
                         languages: list[str | None] | None = None,
                         prompt_ids: np.ndarray | None = None,
                         forced_prefix: list[int | None] | None = None):
        """Multi-stream session with PER-STREAM language prompts: each row of
        the batched chunk step is conditioned by its own prompt id
        (`languages[i]`; None/'auto' = auto-detect)."""
        if languages is not None:
            prompt_ids = np.asarray([
                self.metadata.prompt_id(None if lang in (None, "auto") else lang)
                if self.spec.multilingual else 0
                for lang in languages
            ], np.int32)
        elif prompt_ids is None:
            prompt_ids = np.full(n_streams, self.prompt_id, np.int32)
        return super().make_multi_state(
            n_streams, prompt_ids=prompt_ids, forced_prefix=forced_prefix
        )

    def make_state(self, forced_prefix: int | None = None) -> _StreamState:
        """`forced_prefix`: seed the decoder as if that token (a `<xx-XX>`
        lang tag) was just emitted; the decode state holds h/c from BEFORE
        last_token was consumed, so setting last_token alone is the exact
        seeding (the warm start consumes it first)."""
        return self._make_state(forced_prefix)

    def _prompt_ids(self, device) -> torch.Tensor:
        return torch.tensor([self.prompt_id], dtype=torch.int32, device=device)

    def _apply_encoder(self, mel_chunk, caches, prompt_ids):
        """MultiStreamMixin hook: per-STREAM prompt conditioning."""
        return self.encoder(mel_chunk, caches, prompt_ids)

    def _host_advance(self, state, raw_tokens, frames,
                      eou_raw: bool = False) -> EouPartialResult:
        """Host-side chunk bookkeeping, shared VERBATIM between the
        single-stream (`_process_one`) and batched multi-stream
        (`MultiStreamMixin._serve_tick`) paths, so they cannot drift."""
        del eou_raw  # Nemotron has no EOU head
        raw_ids = [int(t) for t in raw_tokens]
        # multilingual: the model emits leading <xx-XX> language-tag tokens —
        # filter them from the transcript, surface the first as the detected
        # language
        tag_ids = self.metadata.lang_tag_token_ids
        ids, ts_ms = [], []
        for t, f in zip(raw_ids, frames):
            if t in tag_ids:
                if state.detected_language is None:
                    piece = self.tokenizer.piece(t) or ""
                    state.detected_language = piece.strip("<>▁ ") or None
                    # mirror of the CURRENT stream's detection (convenience;
                    # per-stream truth lives on the state)
                    self.detected_language = state.detected_language
                continue
            ids.append(t)
            ts_ms.append((state.enc_frames_emitted + int(f)) * 80.0)
        state.tokens.extend(ids)
        state.timestamps_ms.extend(ts_ms)
        state.enc_frames_emitted += self.mel_frames // 8
        state.last_sample = float(state.pending[self.chunk_samples - 1])
        state.pending = state.pending[self.chunk_samples:]
        state.consumed_samples += self.chunk_samples
        partial = EouPartialResult(
            text=self.tokenizer.decode(state.tokens),
            token_ids=ids,
            timestamps_ms=ts_ms,
            is_final=False,
            eou_detected=False,
        )
        if self.on_partial:
            self.on_partial(partial)
        return partial
