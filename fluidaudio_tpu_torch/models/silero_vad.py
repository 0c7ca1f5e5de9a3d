"""Silero VAD v5 network, in PyTorch.

Port of `fluidaudio_tpu/models/silero_vad.py` (reference
`VAD/VadManager.swift:14-30`): the upstream silero-vad v5 model at its
native 32 ms frame granularity (64 context + 512 new samples), split into
its data-parallel and state-serial halves:

* `SileroVadV5.encode` — reflect pad 64, the 258-filter STFT-basis conv,
  magnitude sqrt(re^2 + im^2 + 1e-12), the 4-layer conv encoder and a time
  mean. It depends only on audio, so every frame of a batch of utterances
  runs as one batched conv stack.
* the LSTM cell (gate order i, f, g, o) and the sigmoid head. The
  frame program projects the input side of every frame at once, runs only
  the 128 x 512 recurrent product and the gates per frame, and applies the
  head to all hidden states afterwards.

`vad_frame_program` runs the recurrence as a loop of device ops with no host
sync inside it; on a CUDA device `FrameProgram` captures that loop once per
(batch, frames) shape as a CUDA graph (JAX compiles one program per
shape), so a call replays the graph instead of launching each op.

Parameter names mirror the flax tree (`stft_basis.weight` for
`params/stft_basis/kernel` [256, 1, 258] -> [258, 1, 256]), so
`utils.weights.load_npz` maps the JAX package's npz checkpoints directly.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F


@dataclass(frozen=True)
class SileroV5Config:
    """Upstream silero-vad v5 topology (from the published jit state dict:
    stft.forward_basis_buffer [258,1,256]; encoder.{0..3}.reparam_conv;
    decoder.rnn LSTMCell(128); decoder.decoder.2 Conv1d(128,1,1))."""

    context_size: int = 64
    frame_size: int = 512
    stft_kernel: int = 256
    stft_stride: int = 128
    stft_pad: int = 64  # reflect pad both sides before the basis conv
    encoder_dims: tuple[int, ...] = (128, 64, 64, 128)
    encoder_strides: tuple[int, ...] = (1, 2, 2, 1)
    hidden: int = 128

    @property
    def window_size(self) -> int:
        return self.context_size + self.frame_size  # 576


def lstm_gates(zz: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(i, f, g, o) gate math of the cell and the frame program."""
    i, f, g, o = zz.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return h2, c2


class _LstmCell(nn.Module):
    def __init__(self, hidden: int, device=None):
        super().__init__()
        self.ih = nn.Linear(hidden, 4 * hidden, device=device)
        self.hh = nn.Linear(hidden, 4 * hidden, device=device)

    def forward(self, x, h, c):
        return lstm_gates(self.ih(x) + self.hh(h), c)


class SileroVadV5(nn.Module):
    """One 32 ms frame step: (frame [B, 576], h [B, 128], c [B, 128]) ->
    (prob [B], h', c'). The first 129 STFT-basis filters are the real part,
    the last 129 the imaginary part."""

    def __init__(self, cfg: SileroV5Config = SileroV5Config(), device=None):
        super().__init__()
        self.cfg = cfg
        n_bins = cfg.stft_kernel // 2 + 1  # 129
        self.stft_basis = nn.Conv1d(1, 2 * n_bins, cfg.stft_kernel, stride=cfg.stft_stride,
                                    bias=False, device=device)
        dims = (n_bins,) + tuple(cfg.encoder_dims)
        for i, stride in enumerate(cfg.encoder_strides):
            self.add_module(f"enc{i}", nn.Conv1d(dims[i], dims[i + 1], 3, stride=stride,
                                                 padding=1, device=device))
        self.lstm = _LstmCell(cfg.hidden, device)
        self.head = nn.Linear(cfg.hidden, 1, device=device)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """[N, 576] audio frames -> [N, 128] features (no recurrent state)."""
        cfg = self.cfg
        n_bins = cfg.stft_kernel // 2 + 1
        x = F.pad(frames[:, None, :], (cfg.stft_pad, cfg.stft_pad), mode="reflect")
        spec = self.stft_basis(x)  # [N, 258, t]
        y = torch.sqrt(spec[:, :n_bins] ** 2 + spec[:, n_bins:] ** 2 + 1e-12)
        for i in range(len(cfg.encoder_strides)):
            y = F.relu(getattr(self, f"enc{i}")(y))
        return y.mean(dim=2)

    @torch.no_grad()
    def forward(self, frame: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        h2, c2 = self.lstm(self.encode(frame), h, c)
        prob = torch.sigmoid(self.head(F.relu(h2))[:, 0])
        return prob, h2, c2


@torch.no_grad()
def vad_frame_program(model: SileroVadV5, audio: torch.Tensor, h0: torch.Tensor,
                      c0: torch.Tensor, last_idx: torch.Tensor | None = None):
    """Whole-utterance (or batch-of-utterances) forward, all on `audio`'s device.

    audio [B, 64 + N*512]: per-row initial context prepended to the raw
    samples; frame j of row b is audio[b, j*512 : j*512 + 576]. int16 audio
    is upcast on the device by 1/32768. h0/c0 [B, 128]. last_idx [B]: the
    index of each row's last real frame (rows are bucket-padded; the causal
    recurrence keeps the pad tail out of it).

    -> (frame_probs [B, N], h_final [B, 128], c_final [B, 128]), the final
    state gathered on the device at `last_idx`.
    """
    cfg = model.cfg
    if not audio.is_floating_point():
        audio = audio.float() / 32768.0
    B, total = audio.shape
    n_frames = (total - cfg.context_size) // cfg.frame_size
    if last_idx is None:
        last_idx = torch.full((B,), n_frames - 1, dtype=torch.int32, device=audio.device)
    frames = audio.unfold(1, cfg.window_size, cfg.frame_size)[:, :n_frames]  # [B, N, 576]
    feats = model.encode(frames.reshape(B * n_frames, cfg.window_size)).reshape(B, n_frames, -1)

    lstm = model.lstm
    z_ih = feats @ lstm.ih.weight.T + lstm.ih.bias  # [B, N, 4H], batched
    w_hh, b_hh = lstm.hh.weight.T, lstm.hh.bias
    h, c = h0, c0
    hs, cs = [], []
    for t in range(n_frames):
        h, c = lstm_gates(z_ih[:, t] + h @ w_hh + b_hh, c)
        hs.append(h)
        cs.append(c)
    hs = torch.stack(hs, dim=1)  # [B, N, H]
    cs = torch.stack(cs, dim=1)

    probs = torch.sigmoid(F.relu(hs) @ model.head.weight.T + model.head.bias)[..., 0]
    rows = torch.arange(B, device=audio.device)
    last = last_idx.long()
    return probs, hs[rows, last], cs[rows, last]


class FrameProgram:
    """`vad_frame_program` at one (batch, frames, dtype) shape. On a CUDA
    device the first call warms up and captures the program as a CUDA graph
    over static input buffers; later calls copy their inputs in and replay
    it. On the CPU it calls the program directly.

    `pool` (a `torch.cuda.graph_pool_handle()`) is the memory pool the
    capture allocates from. Programs that share one pool share the memory of
    their intermediates, which is safe because they replay one at a time on
    one stream and each writes its intermediates before it reads them.
    `stream` is the side stream of the warm-up run; programs that share one
    reuse its cached blocks (the allocator reuses a freed block only on the
    stream that freed it)."""

    def __init__(self, model: SileroVadV5, pool=None, stream: torch.cuda.Stream | None = None):
        self.model = model
        self.pool = pool
        self.stream = stream
        self.graph: torch.cuda.CUDAGraph | None = None
        self.static_in: tuple[torch.Tensor, ...] = ()
        self.static_out: tuple[torch.Tensor, ...] = ()

    def __call__(self, audio, h0, c0, last_idx):
        if audio.device.type != "cuda":
            return vad_frame_program(self.model, audio, h0, c0, last_idx)
        if self.graph is None:
            self.static_in = tuple(x.clone() for x in (audio, h0, c0, last_idx))
            stream = self.stream or torch.cuda.Stream(audio.device)
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):  # warm-up outside the graph
                vad_frame_program(self.model, *self.static_in)
            torch.cuda.current_stream().wait_stream(stream)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=self.pool):
                self.static_out = vad_frame_program(self.model, *self.static_in)
        for dst, src in zip(self.static_in, (audio, h0, c0, last_idx)):
            dst.copy_(src)
        self.graph.replay()
        return tuple(x.clone() for x in self.static_out)
