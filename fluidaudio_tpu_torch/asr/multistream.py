"""Multi-stream batched serving for the streaming ASR families, in PyTorch.

Port of `fluidaudio_tpu/asr/multistream.py`. The N streams' mel pre-caches,
conformer channel/time caches and RNN-T decoder states are packed along a
batch axis on the device, and one serving tick runs one batched chunk step
(mel -> encoder -> greedy RNN-T decode) for every stream:

- rows without a full chunk this tick are masked (`active=False`): their
  caches and decoder state pass through unchanged (`torch.where`), so each
  stream stays identical to the single-stream path;
- one device->host copy per tick brings back every stream's tokens, frame
  times, counts and EOU flags together;
- host-side text assembly (debounce, language-tag filtering, callbacks)
  stays per stream and reuses the single-stream bookkeeping
  (`_host_advance`) unchanged.

`set_mesh(None)` keeps single-device serving, as in JAX; a mesh raises
NotImplementedError until the torch.distributed slice (ROADMAP Queue A
item 7e).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from fluidaudio_tpu_torch.models.conformer_streaming import StreamingCaches, init_caches
from fluidaudio_tpu_torch.ops.tdt_decode import (
    TdtDecodeState,
    make_initial_state,
    tdt_greedy_decode,
)

__all__ = [
    "MultiStreamSession",
    "MultiStreamMixin",
]

# `MEL_WIN - MEL_HOP`: the look-ahead a chunk needs past its own samples
LOOKAHEAD_SAMPLES = 240


# ---------------------------------------------------------------- helpers
# Batch axes are NOT uniform across the carried state (conformer caches and
# LSTM h/c put batch on axis 1, the rest on axis 0), so masking is written
# out per field instead of guessed from shapes.


def _mask_caches(active: torch.Tensor, new: StreamingCaches,
                 old: StreamingCaches) -> StreamingCaches:
    """Row-select: active rows take the new caches, masked rows keep theirs."""
    m0 = active[:, None, None]  # [B,1,1]   batch on axis 0
    m1 = active[None, :, None, None]  # [1,B,1,1] batch on axis 1
    return StreamingCaches(
        pre_cache=torch.where(m0, new.pre_cache, old.pre_cache),
        channel=torch.where(m1, new.channel, old.channel),
        time=torch.where(m1, new.time, old.time),
        channel_len=torch.where(active, new.channel_len, old.channel_len),
    )


def _mask_dec_state(active: torch.Tensor, new: TdtDecodeState,
                    old: TdtDecodeState) -> TdtDecodeState:
    m1 = active[None, :, None]  # [1,B,1] h/c are [L,B,H]
    return TdtDecodeState(
        h=torch.where(m1, new.h, old.h),
        c=torch.where(m1, new.c, old.c),
        last_token=torch.where(active, new.last_token, old.last_token),
        time_jump=torch.where(active, new.time_jump, old.time_jump),
    )


def chunk_outputs_to_host(tokens: torch.Tensor, times: torch.Tensor, counts: torch.Tensor,
                          eou: torch.Tensor) -> tuple[np.ndarray, ...]:
    """tokens/times [B, M], counts/eou [B] -> the same four as numpy arrays,
    through ONE device->host copy (packed into one int32 tensor)."""
    M = tokens.shape[1]
    packed = torch.cat([tokens.to(torch.int32), times.to(torch.int32),
                        counts.to(torch.int32)[:, None], eou.to(torch.int32)[:, None]], dim=1)
    host = packed.cpu().numpy()
    return host[:, :M], host[:, M:2 * M], host[:, 2 * M], host[:, 2 * M + 1].astype(bool)


@dataclass
class _HostStream:
    """Per-stream host-side bookkeeping: the fields of the single-stream
    `_StreamState` minus the device tensors (those live batched on the
    session)."""

    pending: np.ndarray
    last_sample: float = 0.0
    consumed_samples: int = 0
    enc_frames_emitted: int = 0
    tokens: list[int] = field(default_factory=list)
    timestamps_ms: list[float] = field(default_factory=list)
    last_eou_ms: float = -1e9
    detected_language: str | None = None
    # `MultiStreamEouManager`: the slot is closed, its row steps masked
    ended: bool = False


@dataclass
class MultiStreamSession:
    """N concurrent streams served by one batched chunk step."""

    streams: list[_HostStream]
    caches: StreamingCaches  # batched [.., B, ..]
    dec_state: TdtDecodeState  # batched
    prompt_ids: np.ndarray | None = None  # [B] (multilingual Nemotron)

    @property
    def n(self) -> int:
        return len(self.streams)


class MultiStreamMixin:
    """Multi-stream serving for a streaming chunk manager.

    Host classes provide: `chunk_samples`, `mel_frames`, `enc_cfg`,
    `pred_cfg`, `dcfg`, `mel`, `predictor`, `joint`, `device`, plus the two
    hooks `_apply_encoder(mel_chunk, caches, prompt_ids)` and
    `_host_advance(state, raw_ids, frames, eou_raw) -> partial` (the latter
    shared verbatim with the single-stream `_process_one`, so both paths
    stay behavior-identical by construction).
    """

    @property
    def _need(self) -> int:
        return self.chunk_samples + LOOKAHEAD_SAMPLES

    def set_mesh(self, mesh) -> None:
        """`None` (no mesh) serves the streams on one device, as in JAX
        (whose reset of its jitted chunk program has no counterpart here:
        the chunk step is eager). Mesh-sharded multi-stream serving waits
        for the torch.distributed slice (ROADMAP Queue A item 7e)."""
        if mesh is not None:
            raise NotImplementedError(
                "set_mesh: multi-GPU serving over torch.distributed is not ported yet "
                "(ROADMAP Queue A item 7e); serve the streams on one device")

    # ------------------------------------------------------------ session

    def make_multi_state(self, n_streams: int, *,
                         prompt_ids: np.ndarray | None = None,
                         forced_prefix: list[int | None] | None = None,
                         ) -> MultiStreamSession:
        caches = init_caches(self.enc_cfg, n_streams, self.device)
        dec = make_initial_state(self.dcfg, self.pred_cfg.n_layers, self.pred_cfg.pred_hidden,
                                 n_streams, device=self.device)
        if forced_prefix is not None:
            lt = dec.last_token.cpu().numpy()
            for i, tok in enumerate(forced_prefix):
                if tok is not None:
                    lt[i] = int(tok)
            dec = dec._replace(last_token=torch.from_numpy(lt).to(self.device))
        return MultiStreamSession(
            streams=[_HostStream(pending=np.zeros(0, np.float32)) for _ in range(n_streams)],
            caches=caches, dec_state=dec,
            prompt_ids=(np.asarray(prompt_ids, np.int32) if prompt_ids is not None
                        else np.zeros(n_streams, np.int32)),
        )

    # -------------------------------------------------------- device step

    def _decode_chunk(self, enc: torch.Tensor, dec_state: TdtDecodeState):
        """Greedy RNN-T over one chunk's frames for every row; the decode
        state carries across chunks with `time_jump` zeroed."""
        B, T = enc.shape[0], enc.shape[1]
        result = tdt_greedy_decode(
            self.dcfg, self.predictor, self.joint, enc,
            torch.full((B,), T, dtype=torch.int32, device=enc.device), dec_state)
        state = result.state._replace(time_jump=torch.zeros_like(result.state.time_jump))
        return result, state

    def _mel_chunk(self, windows: torch.Tensor, last_samples: torch.Tensor) -> torch.Tensor:
        mel_chunk, _ = self.mel(windows, last_samples=last_samples)
        return mel_chunk[:, :, : self.mel_frames]

    def _multi_chunk_step(self, windows, last_samples, caches, dec_state, active, prompt_ids):
        mel_chunk = self._mel_chunk(windows, last_samples)
        enc, new_caches = self._apply_encoder(mel_chunk, caches, prompt_ids)
        result, new_state = self._decode_chunk(enc, dec_state)
        new_caches = _mask_caches(active, new_caches, caches)
        new_state = _mask_dec_state(active, new_state, dec_state)
        counts = torch.where(active, result.counts, 0)
        eou = result.eou_detected & active
        return result.tokens, result.token_times, counts, eou, new_caches, new_state

    # -------------------------------------------------------------- serve

    def process_multi(self, session: MultiStreamSession,
                      audios: list[np.ndarray | None]) -> list[list]:
        """Feed per-stream 16 kHz samples (None/empty: no new audio for that
        stream this call) and serve every full chunk; returns, per stream,
        the list of partial results emitted this call."""
        if len(audios) != session.n:
            raise ValueError(f"expected {session.n} audio entries")
        for s, a in zip(session.streams, audios):
            if a is not None and np.size(a):
                s.pending = np.concatenate([s.pending, np.asarray(a, np.float32).reshape(-1)])
        out: list[list] = [[] for _ in range(session.n)]
        while True:
            active = np.array([s.pending.size >= self._need for s in session.streams])
            if not active.any():
                return out
            self._serve_tick(session, active, out)

    def flush_multi(self, session: MultiStreamSession,
                    streams: list[int] | None = None) -> list:
        """Zero-pad and flush the listed streams' tails (all by default): the
        multi-stream `finish()`. Returns one final result per flushed stream,
        in the given order."""
        idx = list(range(session.n)) if streams is None else list(streams)
        for i in idx:
            s = session.streams[i]
            if s.pending.size > 0:
                pad = (-s.pending.size) % self._need
                s.pending = np.concatenate([s.pending, np.zeros(pad, np.float32)])
        chosen = set(idx)
        while True:
            active = np.array([i in chosen and s.pending.size >= self._need
                               for i, s in enumerate(session.streams)])
            if not active.any():
                break
            self._serve_tick(session, active, [[] for _ in range(session.n)])
        return [self._final_result(session.streams[i]) for i in idx]

    def _serve_tick(self, session: MultiStreamSession, active: np.ndarray,
                    out: list[list]) -> None:
        B, need = session.n, self._need
        windows = np.zeros((B, need), np.float32)
        last = np.zeros((B,), np.float32)
        for i, s in enumerate(session.streams):
            if active[i]:
                windows[i] = s.pending[:need]
                last[i] = s.last_sample
        dev = self.device
        tokens, times, counts, eou, caches, dec = self._multi_chunk_step(
            torch.from_numpy(windows).to(dev), torch.from_numpy(last).to(dev),
            session.caches, session.dec_state, torch.from_numpy(active).to(dev),
            torch.from_numpy(session.prompt_ids).to(dev))
        session.caches, session.dec_state = caches, dec
        tokens_h, times_h, counts_h, eou_h = chunk_outputs_to_host(tokens, times, counts, eou)
        for i, s in enumerate(session.streams):
            if not active[i]:
                continue
            count = int(counts_h[i])
            out[i].append(self._host_advance(s, tokens_h[i][:count], times_h[i][:count],
                                             bool(eou_h[i])))
