"""Speaker segmentation networks (pyannote-style powerset), in PyTorch.

Port of `fluidaudio_tpu/models/pyannote_seg.py`: waveform [B, 160000] (10 s)
-> powerset logits [B, 589, 7] over the classes {∅, S1, S2, S3, S1S2, S1S3,
S2S3}.

- `PyannoteSegmentation` (the "attention" arch): a learned-filterbank conv
  stem (k 251, stride 10) and three stride-3 conv + LayerNorm stages to 589
  frames, then pre-LN self-attention + GELU feed-forward blocks, a tanh
  projection and the 7-class head.
- `PyanNet` (upstream pyannote/segmentation-3.0): SincNet stem (the filters
  materialised as a plain conv), max-pool + instance norm + leaky ReLU
  blocks, a 4-layer BiLSTM (torch gate order i, f, g, o), two leaky-ReLU
  linears and the classifier; logits, not log-softmax.

Flax defaults are kept where they differ from torch's: LayerNorm eps 1e-6,
the tanh GELU, `padding="SAME"` on strided convs (padded explicitly, low
side total // 2, which torch's `padding="same"` cannot do at stride > 1),
VALID max-pool windows, and the instance norm's biased variance at eps 1e-5.

Module and parameter names mirror the flax tree, so `utils.weights.load_npz`
maps the JAX package's npz directly (the attention blocks' DenseGeneral
kernels by its DenseGeneral rule; each BiLSTM direction's `cell/ih` and
`cell/hh` Dense onto one `torch.lstm` call).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

POWERSET_CLASSES = 7
NUM_SPEAKERS = 3
WINDOW_SAMPLES = 160_000  # 10 s
NUM_FRAMES = 589

# class -> active speaker bitmask over 3 slots (reference powerset table)
POWERSET_TABLE = np.array(
    [
        [0, 0, 0],  # silence
        [1, 0, 0],  # S1
        [0, 1, 0],  # S2
        [0, 0, 1],  # S3
        [1, 1, 0],  # S1+S2
        [1, 0, 1],  # S1+S3
        [0, 1, 1],  # S2+S3
    ],
    dtype=np.float32,
)


@dataclass(frozen=True)
class SegmentationConfig:
    conv_channels: tuple[int, ...] = (80, 128, 128, 128)
    d_model: int = 128
    n_attention_layers: int = 2
    n_heads: int = 4
    dtype: str = "float32"


def _same_conv1d(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """Flax `padding="SAME"`: out = ceil(T / stride), the total pad split with
    total // 2 on the low side."""
    T = x.shape[-1]
    (k,), (s,) = conv.kernel_size, conv.stride
    out = -(-T // s)
    total = max((out - 1) * s + k - T, 0)
    return conv(F.pad(x, (total // 2, total - total // 2)))


class _SelfAttention(nn.Module):
    """flax `nn.SelfAttention`: DenseGeneral q/k/v to [H, Dh] with biases,
    the query scaled by 1/sqrt(Dh) before the product, an f32 softmax over
    all frames, and a DenseGeneral output over (H, Dh)."""

    def __init__(self, d: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(d, d, device=device)
        self.key = nn.Linear(d, d, device=device)
        self.value = nn.Linear(d, d, device=device)
        self.out = nn.Linear(d, d, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, d = x.shape
        H = self.heads
        Dh = d // H
        q = self.query(x).reshape(B, T, H, Dh) / np.sqrt(Dh).astype(np.float32)
        k = self.key(x).reshape(B, T, H, Dh)
        v = self.value(x).reshape(B, T, H, Dh)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k).float(), dim=-1).to(x.dtype)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, d))


class PyannoteSegmentation(nn.Module):
    """waveform [B, 160000] -> logits [B, 589, 7] (f32)."""

    def __init__(self, cfg: SegmentationConfig = SegmentationConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        ch = cfg.conv_channels
        d = ch[-1]
        self.stem = nn.Conv1d(1, ch[0], 251, stride=10, device=device)
        for i, (c_in, c_out) in enumerate(zip(ch[:-1], ch[1:])):
            self.add_module(f"conv{i}", nn.Conv1d(c_in, c_out, 5, stride=3, device=device))
            self.add_module(f"ln{i}", nn.LayerNorm(c_out, eps=1e-6, device=device))
        for i in range(cfg.n_attention_layers):
            self.add_module(f"att_ln{i}", nn.LayerNorm(d, eps=1e-6, device=device))
            self.add_module(f"att{i}", _SelfAttention(d, cfg.n_heads, device))
            self.add_module(f"ffn_ln{i}", nn.LayerNorm(d, eps=1e-6, device=device))
            self.add_module(f"ffn1_{i}", nn.Linear(d, cfg.d_model * 4, device=device))
            self.add_module(f"ffn2_{i}", nn.Linear(cfg.d_model * 4, cfg.d_model, device=device))
        self.proj = nn.Linear(cfg.d_model, cfg.d_model, device=device)
        self.head = nn.Linear(cfg.d_model, POWERSET_CLASSES, device=device)
        self.to(getattr(torch, cfg.dtype))

    @torch.no_grad()
    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = waveform[:, None, :].to(self.stem.weight.dtype)  # [B, 1, T]
        x = torch.abs(_same_conv1d(x, self.stem))
        for i in range(len(cfg.conv_channels) - 1):
            x = F.relu(_same_conv1d(x, getattr(self, f"conv{i}")))
            x = getattr(self, f"ln{i}")(x.transpose(1, 2)).transpose(1, 2)
        x = x.transpose(1, 2)  # [B, T, C]
        T = x.shape[1]
        x = x[:, :NUM_FRAMES] if T >= NUM_FRAMES else F.pad(x, (0, 0, 0, NUM_FRAMES - T))
        for i in range(cfg.n_attention_layers):
            x = x + getattr(self, f"att{i}")(getattr(self, f"att_ln{i}")(x))
            f = getattr(self, f"ffn1_{i}")(getattr(self, f"ffn_ln{i}")(x))
            x = x + getattr(self, f"ffn2_{i}")(F.gelu(f, approximate="tanh"))
        x = torch.tanh(self.proj(x))
        return self.head(x).float()


# --------------------------------------------------------------------------
# Checkpoint-convertible PyanNet (upstream pyannote/segmentation-3.0 layout)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PyanNetConfig:
    """pyannote.audio PyanNet hyperparameters (segmentation-3.0)."""

    sinc_filters: int = 80
    sinc_kernel: int = 251
    sinc_stride: int = 10
    conv_channels: int = 60
    conv_kernel: int = 5
    pool: int = 3
    lstm_hidden: int = 128
    lstm_layers: int = 4
    linear_dims: tuple[int, ...] = (128, 128)
    n_classes: int = POWERSET_CLASSES
    dtype: str = "float32"


class _InstanceNorm(nn.Module):
    """InstanceNorm1d(affine=True) with batch-item statistics over time
    (biased variance, eps 1e-5) on [B, C, T]."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch, device=device))
        self.bias = nn.Parameter(torch.zeros(ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        return y * self.weight.to(x.dtype)[:, None] + self.bias.to(x.dtype)[:, None]


class _LstmCell(nn.Module):
    """The flax `cell` of one direction: `ih` and `hh` Dense, 4H gates."""

    def __init__(self, d_in: int, hidden: int, device=None):
        super().__init__()
        self.ih = nn.Linear(d_in, 4 * hidden, device=device)
        self.hh = nn.Linear(hidden, 4 * hidden, device=device)

    def flat(self) -> list[torch.Tensor]:
        return [self.ih.weight, self.hh.weight, self.ih.bias, self.hh.bias]


class _LstmDirection(nn.Module):
    def __init__(self, d_in: int, hidden: int, device=None):
        super().__init__()
        self.cell = _LstmCell(d_in, hidden, device)


def bilstm(x: torch.Tensor, fwd: _LstmCell, bwd: _LstmCell) -> torch.Tensor:
    """[B, T, I] -> [B, T, 2H]: the forward direction, then the backward one
    run over the reversed sequence and reversed back, concatenated; zero
    initial state (one `torch.lstm` call, cuDNN on the GPU)."""
    B = x.shape[0]
    H = fwd.hh.weight.shape[1]
    h0 = x.new_zeros(2, B, H)
    out, _, _ = torch.lstm(x, (h0, h0), fwd.flat() + bwd.flat(), True, 1, 0.0, False, True, True)
    return out


class PyanNet(nn.Module):
    """waveform [B, 160000] -> logits [B, 589, 7] (f32): wav instance norm,
    then per block conv -> (|.| on block 0) -> max-pool -> instance norm ->
    leaky ReLU; the 4-layer BiLSTM; two leaky-ReLU linears; the classifier."""

    def __init__(self, cfg: PyanNetConfig = PyanNetConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        self.wav_norm = _InstanceNorm(1, device)
        self.sinc = nn.Conv1d(1, cfg.sinc_filters, cfg.sinc_kernel, stride=cfg.sinc_stride,
                              bias=False, device=device)
        self.norm0 = _InstanceNorm(cfg.sinc_filters, device)
        c_in = cfg.sinc_filters
        for i in (1, 2):
            self.add_module(f"conv{i}", nn.Conv1d(c_in, cfg.conv_channels, cfg.conv_kernel,
                                                  device=device))
            self.add_module(f"norm{i}", _InstanceNorm(cfg.conv_channels, device))
            c_in = cfg.conv_channels
        for layer in range(cfg.lstm_layers):
            for side in ("fwd", "bwd"):
                self.add_module(f"lstm{layer}_{side}",
                                _LstmDirection(c_in, cfg.lstm_hidden, device))
            c_in = 2 * cfg.lstm_hidden
        for i, dim in enumerate(cfg.linear_dims):
            self.add_module(f"linear{i}", nn.Linear(c_in, dim, device=device))
            c_in = dim
        self.classifier = nn.Linear(c_in, cfg.n_classes, device=device)
        self.to(getattr(torch, cfg.dtype))

    @torch.no_grad()
    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.wav_norm(waveform[:, None, :].to(self.sinc.weight.dtype))  # [B, 1, T]
        x = F.max_pool1d(torch.abs(self.sinc(x)), cfg.pool)
        x = F.leaky_relu(self.norm0(x))
        for i in (1, 2):
            x = F.max_pool1d(getattr(self, f"conv{i}")(x), cfg.pool)
            x = F.leaky_relu(getattr(self, f"norm{i}")(x))
        x = x.transpose(1, 2)  # [B, T, C]
        for layer in range(cfg.lstm_layers):
            x = bilstm(x, getattr(self, f"lstm{layer}_fwd").cell,
                       getattr(self, f"lstm{layer}_bwd").cell)
        for i in range(len(cfg.linear_dims)):
            x = F.leaky_relu(getattr(self, f"linear{i}")(x))
        return self.classifier(x).float()


def powerset_to_binary(logits: torch.Tensor) -> torch.Tensor:
    """[B, T, 7] powerset logits -> [B, T, 3] binary speaker activity (argmax)."""
    table = torch.as_tensor(POWERSET_TABLE, device=logits.device)
    return table[torch.argmax(logits, dim=-1)]


def clean_frame_mask(binary: torch.Tensor) -> torch.Tensor:
    """[B, T, 3] -> [B, T] mask of frames with at most one active speaker
    (overlap frames are excluded from embedding extraction)."""
    return torch.sum(binary, dim=-1) < 2
