"""LS-EEND-style online end-to-end diarizer (<=10 speakers, recurrent), in PyTorch.

Port of `fluidaudio_tpu/models/lseend.py` (reference
`LS-EEND/LSEENDDiarizer.swift:17`, `LSEENDInference.swift`): one streaming
step over a block of 100 ms output frames: a pre-LN self-attention frame
encoder, then the attractor bank [10, D] attends the block's frames
(cross-attention), a GRU-style gated update, and per-frame activities
sigmoid(frame . attractor / sqrt(D)), zeroed before the 900 ms warm-up.

Flax defaults are kept: LayerNorm eps 1e-6, the tanh GELU (`nn.gelu`), the
query scaled by 1/sqrt(Dh) before the product and the softmax in the
compute dtype. Module and parameter names mirror the flax tree: `att{i}`
and `slot_att` are DenseGeneral attention (`query/key/value` [D, H, Dh],
`out` [H, Dh, D]), which `utils.weights.load_npz` maps by name; `slot_init`
[10, D] keeps its layout.

`StepProgram` loops the step over a run of blocks on the device; on the card
the step is one CUDA graph, replayed per block.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

MAX_SPEAKERS = 10
LSEEND_SAMPLE_RATE = 8_000
FRAME_SECONDS = 0.1  # 100 ms output frames


@dataclass(frozen=True)
class LsEendConfig:
    n_mels: int = 23
    context: int = 7  # stacked context frames each side
    subsample: int = 10  # 10 ms mel hop -> 100 ms output frames
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 4
    warmup_frames: int = 9  # 900 ms
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def feat_dim(self) -> int:
        return self.n_mels * (2 * self.context + 1)


LSEEND_BASE = LsEendConfig()
LSEEND_TEST = LsEendConfig(n_mels=8, context=2, d_model=32, n_layers=1, n_heads=4)


class LsEendState(NamedTuple):
    attractors: torch.Tensor  # [B, MAX_SPEAKERS, D]
    frames_seen: torch.Tensor  # [B] int32 (for warm-up gating)


def init_state(cfg: LsEendConfig, batch: int, device=None) -> LsEendState:
    return LsEendState(
        attractors=torch.zeros((batch, MAX_SPEAKERS, cfg.d_model), dtype=cfg.compute_dtype,
                               device=device),
        frames_seen=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def subsample_with_context(logmel: torch.Tensor, cfg: LsEendConfig) -> torch.Tensor:
    """[B, n_mels, T_mel] -> features [B, T_mel//subsample, feat_dim].

    Output frame t stacks mel frames t*sub + sub//2 - ctx .. + ctx (edge clamp).
    """
    B, F_, T = logmel.shape
    x = logmel.transpose(1, 2)
    t_out = T // cfg.subsample
    centers = torch.arange(t_out, device=logmel.device) * cfg.subsample + cfg.subsample // 2
    offsets = torch.arange(-cfg.context, cfg.context + 1, device=logmel.device)
    idx = torch.clamp(centers[:, None] + offsets[None, :], 0, T - 1)  # [T', 2c+1]
    return x[:, idx, :].reshape(B, t_out, cfg.feat_dim)


class _Attention(nn.Module):
    """flax `MultiHeadDotProductAttention` (and `SelfAttention`): DenseGeneral
    q/k/v to [H, Dh] with biases, q / sqrt(Dh), softmax over the keys, a
    DenseGeneral output over (H, Dh)."""

    def __init__(self, d: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(d, d, device=device)
        self.key = nn.Linear(d, d, device=device)
        self.value = nn.Linear(d, d, device=device)
        self.out = nn.Linear(d, d, device=device)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
        B, Tq, d = q_in.shape
        Tk = kv_in.shape[1]
        H = self.heads
        Dh = d // H
        q = self.query(q_in).reshape(B, Tq, H, Dh) / np.float32(np.sqrt(Dh))
        k = self.key(kv_in).reshape(B, Tk, H, Dh)
        v = self.value(kv_in).reshape(B, Tk, H, Dh)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Tq, d))


class LsEendModel(nn.Module):
    """One streaming step over a block of output frames."""

    def __init__(self, cfg: LsEendConfig = LSEEND_BASE, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.input_proj = nn.Linear(cfg.feat_dim, D, device=device)
        for i in range(cfg.n_layers):
            self.add_module(f"ln{i}", nn.LayerNorm(D, eps=1e-6, device=device))
            self.add_module(f"att{i}", _Attention(D, cfg.n_heads, device))
            self.add_module(f"fln{i}", nn.LayerNorm(D, eps=1e-6, device=device))
            self.add_module(f"ff1_{i}", nn.Linear(D, 4 * D, device=device))
            self.add_module(f"ff2_{i}", nn.Linear(4 * D, D, device=device))
        self.slot_init = nn.Parameter(torch.zeros(MAX_SPEAKERS, D, device=device))
        self.slot_att = _Attention(D, cfg.n_heads, device)
        self.gate = nn.Linear(2 * D, D, device=device)
        self.cand = nn.Linear(D, D, device=device)
        self.to(cfg.compute_dtype)

    @torch.no_grad()
    def forward(self, feats: torch.Tensor, state: LsEendState
                ) -> tuple[torch.Tensor, LsEendState]:
        """feats [B, T, feat_dim] -> (activities [B, T, 10] f32, new state)."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        T = feats.shape[1]
        x = self.input_proj(feats.to(dt))
        for i in range(cfg.n_layers):
            h = getattr(self, f"ln{i}")(x)
            x = x + getattr(self, f"att{i}")(h, h)
            f = getattr(self, f"ff1_{i}")(getattr(self, f"fln{i}")(x))
            x = x + getattr(self, f"ff2_{i}")(F.gelu(f, approximate="tanh"))

        # attractor update: slots attend the block's frames, gated (GRU-style)
        first_step = (state.frames_seen == 0)[:, None, None]
        attractors = torch.where(first_step, self.slot_init[None].to(dt), state.attractors)
        attended = self.slot_att(attractors, x)
        z = torch.sigmoid(self.gate(torch.cat([attractors, attended], dim=-1)))
        new_attractors = (1 - z) * attractors + z * torch.tanh(self.cand(attended))

        # per-frame activity = sigmoid(frame . attractor); zero before warm-up
        logits = torch.einsum("btd,bsd->bts", x, new_attractors) / np.float32(
            np.sqrt(cfg.d_model))
        activities = torch.sigmoid(logits.float())
        seen = state.frames_seen[:, None] + torch.arange(T, device=feats.device)[None, :]
        activities = torch.where((seen >= cfg.warmup_frames)[..., None], activities, 0.0)
        return activities, LsEendState(new_attractors, state.frames_seen + T)


class StepProgram:
    """`LsEendModel` looped over blocks. On a CUDA device the first call
    captures one step as a CUDA graph whose state lives in static buffers
    that the graph updates in place; each block then costs a copy of its
    features in, one replay and a copy of its activities out. On the CPU it
    calls the step directly. One program serves one (step_frames, dtype)
    shape at batch 1."""

    def __init__(self, model: LsEendModel):
        self.model = model
        self.graph: torch.cuda.CUDAGraph | None = None

    def _capture(self, feats: torch.Tensor, state: LsEendState) -> None:
        self.feats = feats.clone()
        self.state = LsEendState(*(f.clone() for f in state))
        side = torch.cuda.Stream(feats.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up outside the graph
            self.model(self.feats, self.state)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.acts, new = self.model(self.feats, self.state)
            for dst, src in zip(self.state, new):
                dst.copy_(src)

    @torch.no_grad()
    def scan(self, feats_all: torch.Tensor, state: LsEendState
             ) -> tuple[torch.Tensor, LsEendState]:
        """feats_all [N, T, feat_dim] (B=1 state) -> (activities [N, T, 10],
        state after the N blocks), on the device with no host sync."""
        if feats_all.device.type != "cuda":
            acts = []
            for i in range(feats_all.shape[0]):
                a, state = self.model(feats_all[i : i + 1], state)
                acts.append(a[0])
            return torch.stack(acts), state
        if self.graph is None or self.feats.shape[1:] != feats_all.shape[1:]:
            self._capture(feats_all[:1], state)
        for dst, src in zip(self.state, state):
            dst.copy_(src)
        out = torch.empty((feats_all.shape[0], *self.acts.shape[1:]), dtype=self.acts.dtype,
                          device=self.acts.device)
        for i in range(feats_all.shape[0]):
            self.feats.copy_(feats_all[i : i + 1])
            self.graph.replay()
            out[i].copy_(self.acts[0])
        return out, LsEendState(*(f.clone() for f in self.state))
