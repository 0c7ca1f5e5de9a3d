"""Sortformer end-to-end streaming diarizer (4 fixed speaker slots), in PyTorch.

Port of `fluidaudio_tpu/models/sortformer.py` (reference
`Sortformer/SortformerDiarizer.swift:12`, `SortformerModelInference.swift:
24-46`): a FastConformer encoder and a NeMo transformer head over
[speaker-cache | FIFO | chunk] context producing per-frame 4-speaker sigmoid
activities; the carried state is the speaker cache [188, D] (compressed
history) and the FIFO [40, D] (recent frames). The offline variant runs one
pass per 30.72 s window with no state.

The encoder is the port's `models/conformer.py::ConformerEncoder`, so its
attention runs through the relpos-attention kernel on the GPU wherever the
kernel takes the head width (SORTFORMER_V2: Dh 64, one launch per layer);
the trained fixture (Dh 8) takes the plain version.

The chunk step after the encoder (`streaming_step_from_frames`) is tensor
code only, with no host sync: the FIFO shift by gathers, and the cache
compression's per-speaker top-k as a stable descending sort, whose ties go
to the lower index as `jax.lax.top_k`'s do (the invalid slots all tie at
-1.0). `streaming_scan_program` encodes every chunk of a recording in one
batched call and loops the stateful step over them; on the GPU the step is
a CUDA graph (`StepProgram`), as JAX runs it inside one `lax.scan`.

Module and parameter names mirror the flax tree (`tf0.q.weight`,
`encoder.block0...`), so `utils.weights.load_npz` maps the JAX package's npz.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from fluidaudio_tpu_torch.models.conformer import ConformerConfig, ConformerEncoder

NUM_SPEAKERS = 4
FRAME_SECONDS = 0.08  # 80 ms encoder frames


@dataclass(frozen=True)
class SortformerConfig:
    n_mels: int = 128
    d_model: int = 192  # transformer/context width (post-projection)
    encoder_d_model: int = 512
    n_encoder_layers: int = 17
    n_transformer_layers: int = 18
    n_heads: int = 8
    spkcache_len: int = 188
    fifo_len: int = 40
    chunk_frames: int = 6  # encoder frames per streaming step (~0.48 s)
    # NeMo's updater compresses the speaker cache every `update_period`
    # FIFO pops; this port compresses whenever frames pop (every step with
    # overflow), which subsumes the periodic schedule on fixed-size chunks —
    # kept for converter/config parity with upstream presets
    update_period: int = 31
    dtype: str = "float32"

    # reference constraint floors (`SortformerTypes.swift` init clamping):
    # chunkLen >= 1; spkcacheLen >= (1 + silFramesPerSpk) * numSpeakers = 16;
    # updatePeriod in [chunkLen, fifoLen + chunkLen]
    def __post_init__(self):
        object.__setattr__(self, "chunk_frames", max(1, self.chunk_frames))
        object.__setattr__(self, "spkcache_len", max(16, self.spkcache_len))
        clamped = max(
            min(self.update_period, self.fifo_len + self.chunk_frames),
            self.chunk_frames,
        )
        object.__setattr__(self, "update_period", clamped)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def per_speaker_quota(self) -> int:
        return self.spkcache_len // NUM_SPEAKERS  # 47

    @property
    def frame_duration_seconds(self) -> float:
        return FRAME_SECONDS

    def is_compatible(self, other: "SortformerConfig") -> bool:
        """Same state-tensor shapes => streaming states are interchangeable
        (reference `SortformerConfig.isCompatible(with:)`)."""
        return (
            self.spkcache_len == other.spkcache_len
            and self.fifo_len == other.fifo_len
            and self.chunk_frames == other.chunk_frames
            and self.d_model == other.d_model
        )

    def encoder_config(self) -> ConformerConfig:
        return ConformerConfig(
            n_mels=self.n_mels,
            d_model=self.encoder_d_model,
            n_layers=self.n_encoder_layers,
            n_heads=self.n_heads,
            subsampling_channels=256 if self.encoder_d_model >= 256 else self.encoder_d_model,
            dtype=self.dtype,
        )


# presets (reference SortformerTypes.swift:9-180)
SORTFORMER_V2 = SortformerConfig()
SORTFORMER_TEST = SortformerConfig(
    n_mels=16, d_model=32, encoder_d_model=32, n_encoder_layers=1,
    n_transformer_layers=2, n_heads=4, spkcache_len=16, fifo_len=8,
    chunk_frames=4, update_period=2,
)


class SortformerState(NamedTuple):
    spkcache: torch.Tensor  # [B, spkcache_len, D]
    spkcache_preds: torch.Tensor  # [B, spkcache_len, 4] last compression scores
    # (informational carry: compression itself always rescores the cache
    # with the current pass's predictions — `spk_preds` below)
    spkcache_mask: torch.Tensor  # [B, spkcache_len] bool (valid slots; non-contiguous)
    fifo: torch.Tensor  # [B, fifo_len, D]
    fifo_preds: torch.Tensor  # [B, fifo_len, 4]
    fifo_len_valid: torch.Tensor  # [B] int32


def init_state(cfg: SortformerConfig, batch: int, device=None) -> SortformerState:
    dt = cfg.compute_dtype
    f32 = torch.float32
    return SortformerState(
        spkcache=torch.zeros((batch, cfg.spkcache_len, cfg.d_model), dtype=dt, device=device),
        spkcache_preds=torch.zeros((batch, cfg.spkcache_len, NUM_SPEAKERS), dtype=f32,
                                   device=device),
        spkcache_mask=torch.zeros((batch, cfg.spkcache_len), dtype=torch.bool, device=device),
        fifo=torch.zeros((batch, cfg.fifo_len, cfg.d_model), dtype=dt, device=device),
        fifo_preds=torch.zeros((batch, cfg.fifo_len, NUM_SPEAKERS), dtype=f32, device=device),
        fifo_len_valid=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


class _NemoTfBlock(nn.Module):
    """NeMo TransformerEncoder layer (post-LN): separate q/k/v/out
    projections, then a ReLU feed-forward, each sublayer followed by its
    layer norm (flax default eps 1e-6) on the residual sum. Masked scores
    take `finfo(dtype).min`, so a fully masked row is uniform, never NaN."""

    def __init__(self, d: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        for name in ("q", "k", "v", "out"):
            self.add_module(name, nn.Linear(d, d, device=device))
        self.ln1 = nn.LayerNorm(d, eps=1e-6, device=device)
        self.ffn_in = nn.Linear(d, 4 * d, device=device)
        self.ffn_out = nn.Linear(4 * d, d, device=device)
        self.ln2 = nn.LayerNorm(d, eps=1e-6, device=device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, N, d = x.shape
        H = self.heads
        hd = d // H
        q = self.q(x).reshape(B, N, H, hd)
        k = self.k(x).reshape(B, N, H, hd)
        v = self.v(x).reshape(B, N, H, hd)
        # f32 scores, as JAX's division by a NumPy scalar promotes them
        scores = torch.einsum("bnhd,bmhd->bhnm", q, k).float() / np.float32(math.sqrt(hd))
        scores = torch.where(mask, scores, torch.finfo(x.dtype).min)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        att = torch.einsum("bhnm,bmhd->bnhd", probs, v).reshape(B, N, d)
        x = self.ln1(x + self.out(att))
        return self.ln2(x + self.ffn_out(F.relu(self.ffn_in(x))))


class SortformerModel(nn.Module):
    """FastConformer encoder -> encoder_proj -> NeMo transformer stack ->
    hidden_fc ReLU -> 4-slot sigmoid head."""

    def __init__(self, cfg: SortformerConfig = SORTFORMER_V2, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = ConformerEncoder(cfg.encoder_config(), device)
        self.encoder_proj = nn.Linear(cfg.encoder_d_model, cfg.d_model, device=device)
        for i in range(cfg.n_transformer_layers):
            self.add_module(f"tf{i}", _NemoTfBlock(cfg.d_model, cfg.n_heads, device))
        self.hidden_fc = nn.Linear(cfg.d_model, cfg.d_model, device=device)
        self.head = nn.Linear(cfg.d_model, NUM_SPEAKERS, device=device)
        self.to(cfg.compute_dtype)

    @torch.no_grad()
    def encode_frames(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, n_mels, T_mel] -> frames [B, T_mel//8, d_model]."""
        B, _, T_mel = mel.shape
        lengths = torch.full((B,), T_mel, dtype=torch.int32, device=mel.device)
        enc, _ = self.encoder(mel, lengths)
        return self.encoder_proj(enc.to(self.cfg.compute_dtype))

    @torch.no_grad()
    def predict(self, context: torch.Tensor, context_mask: torch.Tensor) -> torch.Tensor:
        """context [B, N, d_model] (+bool mask [B, N]) -> sigmoid preds [B, N, 4] f32."""
        att = context_mask[:, None, None, :] & context_mask[:, None, :, None]
        x = context
        for i in range(self.cfg.n_transformer_layers):
            x = getattr(self, f"tf{i}")(x, att)
        logits = self.head(F.relu(self.hidden_fc(x)))
        return torch.sigmoid(logits.float())

    @torch.no_grad()
    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """Offline fused pass: mel [B, n_mels, T] -> preds [B, T//8, 4]."""
        frames = self.encode_frames(mel)
        B, T, _ = frames.shape
        return self.predict(frames, torch.ones((B, T), dtype=torch.bool, device=frames.device))


def streaming_step(model: SortformerModel, mel_chunk: torch.Tensor, state: SortformerState,
                   cfg: SortformerConfig) -> tuple[torch.Tensor, SortformerState]:
    """One chunk: returns (chunk preds [B, chunk_frames, 4], new state).

    Context = [spkcache | fifo | chunk]; after prediction the chunk enters the
    FIFO; overflow frames are compressed into the speaker cache by keeping the
    top-scoring frames per speaker (NeMo SortformerStateUpdater semantics).
    """
    return streaming_step_from_frames(model, model.encode_frames(mel_chunk), state, cfg)


def streaming_scan_program(model: SortformerModel, mel_chunks: torch.Tensor,
                           state: SortformerState, cfg: SortformerConfig,
                           n_steps: int | None = None, program: "StepProgram | None" = None
                           ) -> tuple[torch.Tensor, SortformerState]:
    """Whole-recording streaming pass (B=1 state).

    mel_chunks [N, n_mels, chunk_frames*8]: the encoder is stateless per
    chunk, so all N chunks encode as one batched call; the stateful
    transformer-over-[spkcache|fifo|chunk] + cache update then runs chunk by
    chunk on the device, with no host sync (through `program`, a
    `StepProgram`, when given). `n_steps` (default N) stops the loop early:
    the step is causal, so the chunks past it (bucket padding) would not
    change the first `n_steps` predictions.

    Returns (preds [n_steps, chunk_frames, 4], final state).
    """
    frames_all = model.encode_frames(mel_chunks)  # [N, T, D]
    n = frames_all.shape[0] if n_steps is None else n_steps
    return (program or StepProgram(model, cfg)).scan(frames_all, state, n)


class StepProgram:
    """`streaming_step_from_frames` looped over chunks. On a CUDA device the
    first call captures one step as a CUDA graph whose state lives in static
    buffers that the graph updates in place; each chunk then costs a copy
    of its frames in, one replay and a copy of its predictions out, three
    launches where the eager step makes ~440 (SORTFORMER_V2). On the CPU
    (or without capture) it calls the step directly. One program serves
    one (batch, chunk_frames, d_model, dtype) shape."""

    def __init__(self, model: SortformerModel, cfg: SortformerConfig):
        self.model, self.cfg = model, cfg
        self.graph: torch.cuda.CUDAGraph | None = None

    def _capture(self, frames: torch.Tensor, state: SortformerState) -> None:
        self.frames = frames.clone()
        self.state = SortformerState(*(f.clone() for f in state))
        side = torch.cuda.Stream(frames.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up outside the graph
            streaming_step_from_frames(self.model, self.frames, self.state, self.cfg)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.preds, new = streaming_step_from_frames(self.model, self.frames, self.state,
                                                         self.cfg)
            for dst, src in zip(self.state, new):
                dst.copy_(src)

    @torch.no_grad()
    def scan(self, frames_all: torch.Tensor, state: SortformerState, n_steps: int
             ) -> tuple[torch.Tensor, SortformerState]:
        """frames_all [N, T, D] (B=1 state) -> (preds [n_steps, T, 4], state
        after `n_steps` chunks)."""
        if frames_all.device.type != "cuda":
            preds = []
            for i in range(n_steps):
                p, state = streaming_step_from_frames(self.model, frames_all[i : i + 1], state,
                                                      self.cfg)
                preds.append(p[0])
            return torch.stack(preds), state
        if self.graph is None:
            self._capture(frames_all[:1], state)
        for dst, src in zip(self.state, state):
            dst.copy_(src)
        out = torch.empty((n_steps, *self.preds.shape[1:]), dtype=self.preds.dtype,
                          device=self.preds.device)
        for i in range(n_steps):
            self.frames.copy_(frames_all[i : i + 1])
            self.graph.replay()
            out[i].copy_(self.preds[0])
        return out, SortformerState(*(f.clone() for f in self.state))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, L, C], idx [B, M] -> x[b, idx[b, m]] as [B, M, C]."""
    return torch.take_along_dim(x, idx[..., None].long(), dim=1)


@torch.no_grad()
def streaming_step_from_frames(model: SortformerModel, frames: torch.Tensor,
                               state: SortformerState, cfg: SortformerConfig
                               ) -> tuple[torch.Tensor, SortformerState]:
    """`streaming_step` after the (stateless) encoder: frames [B, T, D]."""
    B, T, D = frames.shape
    S, F_ = cfg.spkcache_len, cfg.fifo_len
    dev = frames.device

    context = torch.cat([state.spkcache, state.fifo, frames], dim=1)
    pos = torch.arange(S + F_ + T, device=dev)[None, :]
    fifo_region = (pos >= S) & (pos < S + state.fifo_len_valid[:, None])
    chunk_region = (pos >= S + F_).expand(B, S + F_ + T)
    spk_region = torch.cat(
        [state.spkcache_mask, torch.zeros((B, F_ + T), dtype=torch.bool, device=dev)], dim=1)
    preds = model.predict(context, spk_region | fifo_region | chunk_region)
    chunk_preds = preds[:, S + F_:]

    # refresh cached scores with this pass's predictions
    spk_preds = preds[:, :S]
    fifo_preds = preds[:, S : S + F_]

    # --- FIFO update: append chunk, pop overflow into the compressor -------
    # Valid FIFO frames stay left-compacted: logical content j is fifo[j] for
    # j < valid_len, else frames[j - valid_len]
    valid_len = state.fifo_len_valid.long()  # [B]
    j = torch.arange(F_ + T, device=dev)[None, :]  # [1, F+T]
    fifo_idx = torch.clamp(j, 0, F_ - 1).expand(B, -1)
    frame_idx = torch.clamp(j - valid_len[:, None], 0, T - 1)
    in_fifo = (j < valid_len[:, None])[..., None]
    in_frames = (j < (valid_len[:, None] + T))[..., None]
    zero = torch.zeros((), dtype=frames.dtype, device=dev)
    content = torch.where(in_fifo, _take(state.fifo, fifo_idx),
                          torch.where(in_frames, _take(frames, frame_idx), zero))
    # REFRESHED this pass (full [spkcache|fifo|chunk] context), not the stale
    # per-entry scores from the step each frame entered the FIFO
    zero32 = torch.zeros((), dtype=torch.float32, device=dev)
    content_preds = torch.where(in_fifo, _take(fifo_preds, fifo_idx),
                                torch.where(in_frames, _take(chunk_preds, frame_idx), zero32))

    total = valid_len + T
    overflow = torch.clamp(total - F_, min=0)  # [B]
    new_fifo_valid = torch.clamp(total, max=F_)
    i = torch.arange(F_, device=dev)[None, :]
    shifted = torch.clamp(i + overflow[:, None], 0, F_ + T - 1)
    fifo_keep = (i < new_fifo_valid[:, None])[..., None]
    new_fifo = torch.where(fifo_keep, _take(content, shifted), zero)
    new_fifo_preds = torch.where(fifo_keep, _take(content_preds, shifted), zero32)

    # popped frames: the first `overflow` entries of the logical content (at
    # most T pop per step)
    popped_valid = torch.arange(T, device=dev)[None, :] < overflow[:, None]
    popped = content[:, :T]
    popped_preds = content_preds[:, :T]

    # --- speaker-cache compression: keep top-quota frames per speaker ------
    quota = cfg.per_speaker_quota
    cand = torch.cat([state.spkcache, popped], dim=1)  # [B, S+P, D]
    cand_preds = torch.cat([spk_preds, popped_preds], dim=1)
    cand_valid = torch.cat([state.spkcache_mask, popped_valid], dim=1)
    scores = torch.where(cand_valid[..., None], cand_preds, -1.0).transpose(1, 2)  # [B, 4, S+P]
    # top-k with ties to the lower index (lax.top_k), then temporal order
    # within each speaker's slot block
    top = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :quota]
    order = torch.sort(top, dim=-1).values  # [B, 4, quota]
    flat = order.reshape(B, NUM_SPEAKERS * quota)
    slot_scores = torch.take_along_dim(scores, order, dim=-1)  # [B, 4, quota]

    new_state = SortformerState(
        spkcache=_take(cand, flat),
        spkcache_preds=_take(cand_preds, flat),
        spkcache_mask=(slot_scores >= 0.0).reshape(B, NUM_SPEAKERS * quota),
        fifo=new_fifo,
        fifo_preds=new_fifo_preds,
        fifo_len_valid=new_fifo_valid.to(torch.int32),
    )
    return chunk_preds, new_state
