"""Multi-stream streaming ASR: N live streams batched into one chunk step.

Behavioral parity: reference multi-stream paths (`MultiStreamCommand.swift`,
`NemotronMultilingualMultiStreamBench.swift`), which run N independent
manager instances. Port of `fluidaudio_tpu/asr/multi_stream.py`: the N
streams' conformer caches and decode states stack on the batch axis, so
every `tick()` is one batched chunk step on the device for all streams.

It is a session layer over the port's `MultiStreamMixin`
(`asr/multistream.py`): one `MultiStreamSession` holds the batched state,
and the mixin's per-field masks keep the caches and decoder state of rows
without a full chunk, so a stalled or late-joining stream produces exactly
the transcript it would produce running solo. As in JAX, every `tick()`
steps the full static batch, a tick with no active row included, and the
decode carries `time_jump` zeroed after every tick. `open_stream` reuses
freed slots after `close_stream`, resetting that row in place.

`checkpoint_dir=None` reads the model cache's `Repo.PARAKEET_EOU` folder,
as JAX does (seeded random weights, with a warning, where it holds none).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from fluidaudio_tpu_torch.asr.multistream import MultiStreamSession, _HostStream
from fluidaudio_tpu_torch.asr.streaming_eou import (
    EOU_BLANK_ID,
    EOU_TOKEN_ID,
    EouSpec,
    _StreamingModels,
)
from fluidaudio_tpu_torch.models.conformer_streaming import (
    EOU_120M,
    StreamingConformerConfig,
    StreamingConformerEncoder,
)
from fluidaudio_tpu_torch.ops.tdt_decode import TdtDecodeConfig
from fluidaudio_tpu_torch.registry import DownloadUtils, Repo
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("asr.multistream")


class MultiStreamEouManager(_StreamingModels):
    def __init__(
        self,
        n_streams: int,
        chunk_ms: int = 320,
        *,
        enc_cfg: StreamingConformerConfig | None = None,
        checkpoint_dir: str | Path | None = None,
        rng_seed: int = 0,
        device: torch.device | str | None = None,
        spec: EouSpec | None = None,
    ):
        """`device=None` is the GPU (RuntimeError without one); pass "cpu"
        to run on the CPU. The model is the EOU 120M's predictor and joint
        (640 wide, blank 1026, EOU 1024) over `enc_cfg` (default
        `EOU_120M`), as in JAX; `spec` sets every size and id at once
        instead (e.g. `streaming_eou.EOU_TEST` for the trained fixture)."""
        if spec is None:
            spec = EouSpec(enc_cfg or EOU_120M, pred_hidden=640, joint_hidden=640,
                           eou_token_id=EOU_TOKEN_ID, blank_id=EOU_BLANK_ID)
        elif enc_cfg is not None and enc_cfg != spec.enc_cfg:
            raise ValueError("pass enc_cfg or spec, not two different encoders")
        self.n = n_streams
        self.chunk_ms = chunk_ms
        self.spec = spec
        self.enc_cfg = spec.enc_cfg
        self._build(
            StreamingConformerEncoder(self.enc_cfg), spec.blank_id, spec.pred_hidden,
            spec.joint_hidden,
            TdtDecodeConfig(blank_id=spec.blank_id, durations=(), max_tokens=64,
                            eou_id=spec.eou_token_id),
            device,
        )
        base = (Path(checkpoint_dir) if checkpoint_dir
                else DownloadUtils.repo_dir(Repo.PARAKEET_EOU))
        self._load_weights(base, rng_seed,
                           f"multi-stream EOU ({Repo.PARAKEET_EOU.folder_name})",
                           spec.eou_token_id)
        self.session: MultiStreamSession = self.make_multi_state(n_streams)

    @property
    def streams(self) -> list[_HostStream]:
        return self.session.streams

    def _apply_encoder(self, mel_chunk, caches, prompt_ids):
        """MultiStreamMixin hook (the EOU encoder takes no prompt)."""
        del prompt_ids
        return self.encoder(mel_chunk, caches)

    def _host_advance(self, stream: _HostStream, raw_ids, frames, eou_raw: bool) -> list[int]:
        """MultiStreamMixin hook: append the chunk's tokens and advance the
        stream by one chunk -> the new token ids."""
        del frames, eou_raw
        ids = [int(t) for t in raw_ids]
        stream.tokens.extend(ids)
        stream.last_sample = float(stream.pending[self.chunk_samples - 1])
        stream.pending = stream.pending[self.chunk_samples:]
        stream.consumed_samples += self.chunk_samples
        return ids

    def feed(self, stream_idx: int, audio: np.ndarray) -> None:
        s = self.streams[stream_idx]
        s.pending = np.concatenate([s.pending, np.asarray(audio, np.float32).reshape(-1)])

    def end_stream(self, stream_idx: int) -> None:
        self.streams[stream_idx].ended = True

    # ------------------------------------------------------- ragged slots

    def close_stream(self, stream_idx: int) -> None:
        """Free a slot for reuse (its transcript remains readable until the
        slot is re-opened)."""
        self.streams[stream_idx].ended = True

    def open_stream(self) -> int:
        """Claim a free (ended) slot for a newly-joining stream; resets that
        row's conformer caches, decoder state and transcript in place."""
        for i, s in enumerate(self.streams):
            if s.ended:
                self._reset_slot(i)
                self.streams[i] = _HostStream(pending=np.zeros(0, np.float32))
                return i
        raise RuntimeError(f"all {self.n} stream slots are live")

    @torch.no_grad()
    def _reset_slot(self, i: int) -> None:
        """Zero row i of exactly the fields JAX resets: the conformer caches
        (batch on axis 0 of pre_cache and channel_len, axis 1 of channel and
        time) and the decoder state (h/c [L, B, H], last_token to blank,
        time_jump). Under a mesh, only the rank that holds row i has it."""
        rows = self.session.rows
        if not rows.start <= i < rows.stop:
            return
        i -= rows.start
        c, d = self.session.caches, self.session.dec_state
        c.pre_cache[i] = 0.0
        c.channel[:, i] = 0.0
        c.time[:, i] = 0.0
        c.channel_len[i] = 0
        d.h[:, i] = 0.0
        d.c[:, i] = 0.0
        d.last_token[i] = self.dcfg.blank_id
        d.time_jump[i] = 0

    @property
    def ready(self) -> bool:
        """True when any live stream has a full chunk buffered."""
        return any(s.pending.size >= self._need for s in self.streams if not s.ended)

    def tick(self) -> list[list[int]]:
        """One batched chunk step over the full static batch; returns the
        new token ids per stream ([] for a row without a full chunk)."""
        active = np.array([not s.ended and s.pending.size >= self._need for s in self.streams])
        out: list[list] = [[] for _ in self.streams]
        self._serve_tick(self.session, active, out)
        return [ids[0] if ids else [] for ids in out]

    def transcript(self, stream_idx: int) -> str:
        return self.tokenizer.decode(self.streams[stream_idx].tokens)
