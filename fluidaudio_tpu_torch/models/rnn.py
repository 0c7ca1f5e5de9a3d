"""Length-aware LSTM layers (torch gate order), in PyTorch.

Port of `fluidaudio_tpu/models/rnn.py`. The programs run on padded buckets,
so the bidirectional pass must not let padding flow into the valid region:
the backward direction runs over each row's valid prefix reversed
(`rev[t] = x[L-1-t]`, zeros after), and its output is reversed back the
same way; padded positions output zero.

Each direction is one `torch.lstm` call (cuDNN on the GPU) over the flax
`cell/ih` and `cell/hh` Dense pair: `ih.weight` [4H, I] and `hh.weight`
[4H, H] are torch's `weight_ih` / `weight_hh`, gate order (i, f, g, o), both
biases kept. The zero initial state is JAX's.
"""

from __future__ import annotations

import torch
from torch import nn


class _LstmCell(nn.Module):
    """The flax scan cell of one direction: `ih` and `hh` Dense, 4H gates."""

    def __init__(self, d_in: int, hidden: int, device=None):
        super().__init__()
        self.ih = nn.Linear(d_in, 4 * hidden, device=device)
        self.hh = nn.Linear(hidden, 4 * hidden, device=device)


class LstmCellSeq(nn.Module):
    """Full-sequence unidirectional LSTM: [B, T, I] -> [B, T, H]."""

    def __init__(self, d_in: int, hidden: int, device=None):
        super().__init__()
        self.hidden = hidden
        self.cell = _LstmCell(d_in, hidden, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h0 = x.new_zeros(1, x.shape[0], self.hidden)
        c = self.cell
        out, _, _ = torch.lstm(x, (h0, h0), [c.ih.weight, c.hh.weight, c.ih.bias, c.hh.bias],
                               True, 1, 0.0, False, False, True)
        return out


def reverse_by_length(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse the valid prefix of each row: out[b, t] = x[b, L_b-1-t] for
    t < L_b, zeros after."""
    B, T = x.shape[0], x.shape[1]
    t = torch.arange(T, device=x.device)
    idx = torch.clamp(lengths[:, None].long() - 1 - t[None, :], 0, T - 1)  # [B, T]
    tail = [1] * (x.ndim - 2)
    rev = torch.take_along_dim(x, idx.reshape(B, T, *tail), dim=1)
    valid = (t[None, :] < lengths[:, None]).reshape(B, T, *tail)
    return torch.where(valid, rev, 0.0)


class BiLstm(nn.Module):
    """Length-masked bidirectional LSTM: [B, T, I] -> [B, T, 2*hidden], as
    torch `nn.LSTM(bidirectional=True)` over a packed sequence: padding
    positions output zero and never reach the backward pass."""

    def __init__(self, d_in: int, hidden: int, device=None):
        super().__init__()
        self.fwd = LstmCellSeq(d_in, hidden, device)
        self.bwd = LstmCellSeq(d_in, hidden, device)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        B, T = x.shape[0], x.shape[1]
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int32, device=x.device)
        valid = (torch.arange(T, device=x.device)[None, :] < lengths[:, None])[..., None]
        x = torch.where(valid, x, 0.0)
        fwd = self.fwd(x)
        bwd = reverse_by_length(self.bwd(reverse_by_length(x, lengths)), lengths)
        return torch.where(valid, torch.cat([fwd, bwd], dim=-1), 0.0)
