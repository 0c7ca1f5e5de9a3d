"""True-streaming ASR with end-of-utterance detection (EOU 120M family), in PyTorch.

Port of `fluidaudio_tpu/asr/streaming_eou.py`: chunk tiers 160/320/1280 ms,
the streaming mel frontend (no centering, preemphasis carried across chunks
by the previous chunk's last sample) feeding the cache-aware encoder, an
incremental greedy RNN-T decode with the EOU token (flagged, never emitted),
the 1280 ms EOU debounce, partial-result callbacks and token timestamps in
ms; `finish()` zero-pads and flushes the tail.

Each chunk runs mel -> encoder step -> RNN-T decode on the device with every
cache and the decoder state carried as tensors there, and makes ONE
device->host copy of the chunk's tokens, frame times, count and EOU flag.

`checkpoint_dir=None` reads the model cache as JAX does
(`DownloadUtils.repo_dir(Repo.PARAKEET_EOU)`); where that holds no
`encoder.npz`, `predictor.npz` or `joint.npz` the weights are seeded random
(with a warning).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from fluidaudio_tpu_torch.asr.multistream import MultiStreamMixin, chunk_outputs_to_host
from fluidaudio_tpu_torch.asr.tokenizer import Tokenizer
from fluidaudio_tpu_torch.models.conformer_streaming import (
    EOU_120M,
    StreamingCaches,
    StreamingConformerConfig,
    StreamingConformerEncoder,
    init_caches,
)
from fluidaudio_tpu_torch.models.predictor import PredictorConfig, RnntJoint, RnntPredictor
from fluidaudio_tpu_torch.models.zoo import _placeholder_vocab, disable_tf32, random_init_
from fluidaudio_tpu_torch.ops.mel import MelConfig, MelFrontend
from fluidaudio_tpu_torch.ops.tdt_decode import (
    TdtDecodeConfig,
    TdtDecodeState,
    make_initial_state,
)
from fluidaudio_tpu_torch.registry import DownloadUtils, Repo
from fluidaudio_tpu_torch.utils.device import resolve_device
from fluidaudio_tpu_torch.utils.logging import get_logger
from fluidaudio_tpu_torch.utils.weights import load_npz, load_state

logger = get_logger("asr.eou")

SAMPLE_RATE = 16_000
MEL_WIN = 400
MEL_HOP = 160
EOU_TOKEN_ID = 1024
EOU_BLANK_ID = 1026
EOU_DEBOUNCE_MS = 1280.0

# chunk tiers: ms -> samples consumed per step (mel frames = samples/160)
CHUNK_TIERS_MS = (160, 320, 1280)


@dataclass(frozen=True)
class EouSpec:
    """Model-size spec for the streaming EOU stack (one 120M checkpoint; the
    test spec is the hermetic trained fixture's)."""

    enc_cfg: StreamingConformerConfig
    pred_hidden: int = 640
    joint_hidden: int = 640
    eou_token_id: int = EOU_TOKEN_ID
    blank_id: int = EOU_BLANK_ID  # == predictor vocab_size (blank last)


EOU_DEFAULT = EouSpec(EOU_120M)
EOU_TEST = EouSpec(
    StreamingConformerConfig(
        d_model=64, n_layers=2, n_heads=4, subsampling_channels=32,
        att_context_left=16,
    ),
    pred_hidden=64, joint_hidden=64,
    # tone words 0..15, EOU at 16, blank at 18 (== vocab_size)
    eou_token_id=16, blank_id=18,
)


def compute_token_timestamps_ms(
    base_frame: int, token_frames: list[int], frame_duration_ms: float = 80.0
) -> list[float]:
    """Per-token emission timestamps: (stream base frame + in-window frame)
    x 80 ms encoder frame."""
    return [(base_frame + f) * frame_duration_ms for f in token_frames]


@dataclass
class EouPartialResult:
    text: str
    token_ids: list[int]
    timestamps_ms: list[float]
    is_final: bool  # True when emitted at an EOU boundary
    eou_detected: bool


@dataclass
class _StreamState:
    pending: np.ndarray
    last_sample: float
    consumed_samples: int
    caches: StreamingCaches
    dec_state: TdtDecodeState
    tokens: list[int] = field(default_factory=list)
    timestamps_ms: list[float] = field(default_factory=list)
    last_eou_ms: float = -1e9
    enc_frames_emitted: int = 0
    # multilingual Nemotron: first <xx-XX> tag seen in THIS stream
    detected_language: str | None = None


class _StreamingModels(MultiStreamMixin):
    """The modules and weights every streaming manager builds (the EOU and
    Nemotron managers, and `multi_stream.MultiStreamEouManager`)."""

    def _build(self, encoder: torch.nn.Module, vocab_size: int, pred_hidden: int,
               joint_hidden: int, dcfg: TdtDecodeConfig, device) -> None:
        self.device = resolve_device(device)
        disable_tf32()
        self.chunk_samples = self.chunk_ms * SAMPLE_RATE // 1000
        self.mel_frames = self.chunk_samples // MEL_HOP
        self.pred_cfg = PredictorConfig(
            vocab_size=vocab_size, pred_hidden=pred_hidden, n_layers=1,
            enc_hidden=self.enc_cfg.d_model, joint_hidden=joint_hidden, n_durations=0,
        )
        self.encoder = encoder.to(self.device).eval()
        self.predictor = RnntPredictor(self.pred_cfg, device=self.device).eval()
        self.joint = RnntJoint(self.pred_cfg, device=self.device).eval()
        self.dcfg = dcfg
        self.mel = MelFrontend(MelConfig(center=False, normalize=None), device=self.device)

    def _load_weights(self, base: Path, rng_seed: int, name: str,
                      placeholder_vocab: int) -> None:
        gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        parts = (("encoder", self.encoder), ("predictor", self.predictor),
                 ("joint", self.joint))
        for _, part in parts:
            random_init_(part, gen)
        loaded = False
        for part_name, part in parts:
            f = base / f"{part_name}.npz"
            if f.exists():
                load_state(part, load_npz(f))
                loaded = True
        if not loaded:
            logger.warning("%s: no checkpoints in %s — seeded random init", name, base)
        vocab_file = base / "vocab.json"
        self.tokenizer = (
            Tokenizer.from_json(vocab_file) if vocab_file.exists()
            else Tokenizer(_placeholder_vocab(placeholder_vocab))
        )


class _StreamingManagerBase(_StreamingModels):
    """What the EOU and Nemotron managers share beyond the models: the
    single-stream chunk loop and its flush. Subclasses set the specs and
    provide `_apply_encoder`, `_host_advance` and `_prompt_ids`."""

    def _make_state(self, forced_prefix: int | None = None) -> _StreamState:
        dec_state = make_initial_state(self.dcfg, self.pred_cfg.n_layers,
                                       self.pred_cfg.pred_hidden, 1, device=self.device)
        if forced_prefix is not None:
            dec_state = dec_state._replace(
                last_token=torch.full_like(dec_state.last_token, int(forced_prefix)))
        return _StreamState(
            pending=np.zeros(0, np.float32),
            last_sample=0.0,
            consumed_samples=0,
            caches=init_caches(self.enc_cfg, 1, self.device),
            dec_state=dec_state,
        )

    def process(self, audio: np.ndarray, state: _StreamState) -> list[EouPartialResult]:
        """Feed 16 kHz mono samples; returns partial results per processed chunk."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        state.pending = np.concatenate([state.pending, audio])
        results = []
        while state.pending.size >= self._need:  # chunk + 240-sample look-ahead
            results.append(self._process_one(state))
        return results

    def finish(self, state: _StreamState) -> EouPartialResult:
        """Pad the tail with zeros and flush it (even less than one mel window)."""
        need = self._need
        if state.pending.size > 0:
            pad = (-state.pending.size) % need
            state.pending = np.concatenate([state.pending, np.zeros(pad, np.float32)])
            while state.pending.size >= need:
                self._process_one(state)
        return self._final_result(state)

    def _final_result(self, state) -> EouPartialResult:
        return EouPartialResult(
            text=self.tokenizer.decode(state.tokens),
            token_ids=list(state.tokens),
            timestamps_ms=list(state.timestamps_ms),
            is_final=True,
            eou_detected=False,
        )

    def _process_one(self, state: _StreamState) -> EouPartialResult:
        """mel -> encoder step -> RNN-T decode of one chunk on the device."""
        dev = self.device
        mel_chunk = self._mel_chunk(
            torch.from_numpy(state.pending[: self._need])[None].to(dev),
            torch.tensor([state.last_sample], dtype=torch.float32, device=dev))
        enc, state.caches = self._apply_encoder(mel_chunk, state.caches, self._prompt_ids(dev))
        result, state.dec_state = self._decode_chunk(enc, state.dec_state)
        # one device->host copy for every host-consumed output
        tokens_h, times_h, counts_h, eou_h = chunk_outputs_to_host(
            result.tokens, result.token_times, result.counts, result.eou_detected)
        count = int(counts_h[0])
        return self._host_advance(state, tokens_h[0][:count], times_h[0][:count],
                                  bool(eou_h[0]))


class StreamingEouAsrManager(_StreamingManagerBase):
    def __init__(
        self,
        chunk_ms: int = 320,
        *,
        spec: EouSpec = EOU_DEFAULT,
        checkpoint_dir: str | Path | None = None,
        rng_seed: int = 0,
        on_partial: Callable[[EouPartialResult], None] | None = None,
        on_eou: Callable[[EouPartialResult], None] | None = None,
        device: torch.device | str | None = None,
    ):
        """`device=None` is the GPU (RuntimeError without one); pass "cpu"
        to run on the CPU. `checkpoint_dir=None`: the model cache's
        `Repo.PARAKEET_EOU` folder."""
        if chunk_ms not in CHUNK_TIERS_MS:
            raise ValueError(f"chunk_ms must be one of {CHUNK_TIERS_MS}, got {chunk_ms}")
        self.chunk_ms = chunk_ms
        self.on_partial = on_partial
        self.on_eou = on_eou
        self.spec = spec
        self.enc_cfg: StreamingConformerConfig = spec.enc_cfg
        self._build(
            StreamingConformerEncoder(self.enc_cfg), spec.blank_id, spec.pred_hidden,
            spec.joint_hidden,
            TdtDecodeConfig(blank_id=spec.blank_id, durations=(), max_symbols_per_step=10,
                            max_tokens=64, eou_id=spec.eou_token_id),
            device,
        )
        base = (Path(checkpoint_dir) if checkpoint_dir
                else DownloadUtils.repo_dir(Repo.PARAKEET_EOU))
        self._load_weights(base, rng_seed, f"EOU ({Repo.PARAKEET_EOU.folder_name})",
                           spec.eou_token_id)

    def make_state(self) -> _StreamState:
        return self._make_state()

    def _prompt_ids(self, device) -> torch.Tensor:
        return torch.zeros((1,), dtype=torch.int32, device=device)

    def _apply_encoder(self, mel_chunk, caches, prompt_ids):
        """MultiStreamMixin hook (prompt conditioning is Nemotron-only; the
        EOU encoder ignores it)."""
        del prompt_ids
        return self.encoder(mel_chunk, caches)

    def _host_advance(self, state, raw_ids, frames, eou_raw: bool) -> EouPartialResult:
        """Host-side chunk bookkeeping, shared VERBATIM between the
        single-stream (`_process_one`) and batched multi-stream
        (`MultiStreamMixin._serve_tick`) paths, so they cannot drift."""
        ids = [int(t) for t in raw_ids]
        ts_ms = compute_token_timestamps_ms(
            state.enc_frames_emitted, [int(f) for f in frames]
        )
        state.tokens.extend(ids)
        state.timestamps_ms.extend(ts_ms)
        state.enc_frames_emitted += self.mel_frames // 8
        # advance the stream
        state.last_sample = float(state.pending[self.chunk_samples - 1])
        state.pending = state.pending[self.chunk_samples:]
        state.consumed_samples += self.chunk_samples

        now_ms = state.consumed_samples / SAMPLE_RATE * 1000.0
        eou = eou_raw and (now_ms - state.last_eou_ms) >= EOU_DEBOUNCE_MS
        if eou:
            state.last_eou_ms = now_ms

        partial = EouPartialResult(
            text=self.tokenizer.decode(state.tokens),
            token_ids=ids,
            timestamps_ms=ts_ms,
            is_final=eou,
            eou_detected=eou,
        )
        if self.on_partial:
            self.on_partial(partial)
        if eou and self.on_eou:
            self.on_eou(partial)
        return partial

