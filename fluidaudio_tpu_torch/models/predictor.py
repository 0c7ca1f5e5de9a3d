"""RNN-T prediction network (LSTM) + additive joint, as torch modules.

Port of `fluidaudio_tpu/models/predictor.py`. Versions: v2 vocab 1024 with a
2-layer LSTM 640; v3 vocab 8192 with a 1-layer LSTM 640. The TDT joint emits
vocab+1 token logits (blank last) then `n_durations` duration logits.
Parameter names mirror the flax tree (`lstm0.ih.weight`, `enc_proj.weight`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F


@dataclass(frozen=True)
class PredictorConfig:
    vocab_size: int = 8192  # excludes blank
    pred_hidden: int = 640
    n_layers: int = 1
    enc_hidden: int = 1024
    joint_hidden: int = 640
    n_durations: int = 5  # TDT duration bins [0,1,2,3,4]; 0 => pure RNN-T
    dtype: str = "float32"

    @property
    def blank_id(self) -> int:
        return self.vocab_size

    @property
    def num_token_logits(self) -> int:
        return self.vocab_size + 1

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class LstmCell(nn.Module):
    """One LSTM step with gate order i, f, g, o and two biased projections."""

    def __init__(self, in_features: int, hidden: int, device=None):
        super().__init__()
        self.ih = nn.Linear(in_features, 4 * hidden, device=device)
        self.hh = nn.Linear(hidden, 4 * hidden, device=device)

    def forward(self, x, h, c):
        i, f, g, o = (self.ih(x) + self.hh(h)).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, c_new


class RnntPredictor(nn.Module):
    """Embedding + stacked LSTM, one autoregressive step per call. Token
    `blank_id` (== vocab_size) acts as SOS and embeds to zeros."""

    def __init__(self, cfg: PredictorConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embedding = nn.Parameter(
            torch.zeros(cfg.vocab_size + 1, cfg.pred_hidden, device=device)
        )
        for layer in range(cfg.n_layers):
            self.add_module(f"lstm{layer}", LstmCell(cfg.pred_hidden, cfg.pred_hidden, device))
        self.to(cfg.compute_dtype)

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """tokens [B] int, h/c [L, B, H] -> (g [B, H], h', c')."""
        # blank/SOS embeds to zeros (padding_idx semantics)
        x = F.embedding(tokens.long(), self.embedding)
        x = torch.where((tokens == self.cfg.blank_id)[:, None], 0.0, x)
        new_h, new_c = [], []
        for layer in range(self.cfg.n_layers):
            hl, cl = getattr(self, f"lstm{layer}")(x, h[layer], c[layer])
            new_h.append(hl)
            new_c.append(cl)
            x = hl
        return x, torch.stack(new_h), torch.stack(new_c)

    def init_state(self, batch: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
        z = torch.zeros((self.cfg.n_layers, batch, self.cfg.pred_hidden),
                        dtype=self.cfg.compute_dtype, device=device)
        return z, z.clone()


class RnntJoint(nn.Module):
    """Additive joint: out(relu(enc_proj(f) + pred_proj(g))).
    Output layout: [vocab+1 token logits (blank last) | n_durations logits]."""

    def __init__(self, cfg: PredictorConfig, device=None):
        super().__init__()
        self.enc_proj = nn.Linear(cfg.enc_hidden, cfg.joint_hidden, device=device)
        self.pred_proj = nn.Linear(cfg.pred_hidden, cfg.joint_hidden, device=device)
        self.out = nn.Linear(cfg.joint_hidden, cfg.num_token_logits + cfg.n_durations,
                             device=device)
        self.to(cfg.compute_dtype)

    @torch.no_grad()
    def forward(self, f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return self.out(F.relu(self.enc_proj(f) + self.pred_proj(g)))
