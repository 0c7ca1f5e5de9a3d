"""flax's `nn.MultiHeadDotProductAttention` / `nn.SelfAttention`, in PyTorch.

Shared by the ports of the modules that use flax's own attention layer
(`g2p_seq2seq`, `styletts2`, `supertonic3`): DenseGeneral query/key/value to
[H, Dh] with biases (laid out as `nn.Linear` by `utils/weights.py`), the
query divided by sqrt(Dh) before the product, masked scores replaced (not
offset) by the dtype's min, so a fully masked row is uniform as in flax, a
softmax over the keys, and a DenseGeneral output over (H, Dh).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class FlaxAttention(nn.Module):
    """`forward(q_in [B,Tq,d], kv_in [B,Tk,d] or None (self), mask
    broadcastable to [B,H,Tq,Tk] or None)` -> [B, Tq, d]."""

    def __init__(self, d: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(d, d, device=device)
        self.key = nn.Linear(d, d, device=device)
        self.value = nn.Linear(d, d, device=device)
        self.out = nn.Linear(d, d, device=device)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        kv_in = q_in if kv_in is None else kv_in
        B, Tq, d = q_in.shape
        Tk = kv_in.shape[1]
        H = self.heads
        Dh = d // H
        q = self.query(q_in).reshape(B, Tq, H, Dh) / np.float32(np.sqrt(Dh))
        k = self.key(kv_in).reshape(B, Tk, H, Dh)
        v = self.value(kv_in).reshape(B, Tk, H, Dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
        w = torch.softmax(scores, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, Tq, d))
