"""Speaker embedding network (WeSpeaker ResNet34 + masked stats pooling), in PyTorch.

Port of `fluidaudio_tpu/models/wespeaker.py`: (80-mel fbank [S, T, 80],
frame weights [S, T_w]) -> embeddings [S, 256]: a 2-D ResNet34 trunk, mask-
weighted statistics pooling over time (TSTP), a linear embedding.

The JAX trunk is NHWC over [S, T, F, C]; this one is NCHW over [S, C, T, F]
with the same kernels (`utils.weights` maps flax `[kh, kw, in, out]` to
`[out, in, kh, kw]`), and it permutes to [S, T, F, C] before flattening
F x C, so the `embed` Dense reads its features in the JAX order. Convs are
bias-free; every BatchNorm is the folded inference affine
(`bn_scale`/`bn_bias`). The resblocks pad 1 explicitly, the stem is SAME at
stride 1; the frame weights are resampled nearest (`arange(T) * n // T`);
the pooling divides by max(sum w, 1e-3) and takes sqrt(var + 1e-6).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from fluidaudio_tpu_torch.ops.mel import MelConfig, MelFrontend

EMBEDDING_DIM = 256


@dataclass(frozen=True)
class WeSpeakerConfig:
    n_mels: int = 80
    channels: tuple[int, ...] = (32, 64, 128, 256)
    # ResNet34 stage depths (wespeaker/models/resnet.py BasicBlock layout)
    blocks_per_stage: tuple[int, ...] = (3, 4, 6, 3)
    embedding_dim: int = EMBEDDING_DIM
    dtype: str = "float32"

    @staticmethod
    def tiny() -> "WeSpeakerConfig":
        """Small trunk for tests (same tree shape, 1 block per stage)."""
        return WeSpeakerConfig(blocks_per_stage=(1, 1, 1, 1))


class _BnAffine(nn.Module):
    """Inference-time BatchNorm: y = x * scale + bias over channels (NCHW)."""

    def __init__(self, ch: int, device=None):
        super().__init__()
        self.bn_scale = nn.Parameter(torch.ones(ch, device=device))
        self.bn_bias = nn.Parameter(torch.zeros(ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.bn_scale[:, None, None] + self.bn_bias[:, None, None]


class _ResBlock(nn.Module):
    def __init__(self, c_in: int, ch: int, stride: int, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, ch, 3, stride=stride, padding=1, bias=False, device=device)
        self.bn1 = _BnAffine(ch, device)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1, bias=False, device=device)
        self.bn2 = _BnAffine(ch, device)
        if c_in != ch or stride != 1:
            self.short = nn.Conv2d(c_in, ch, 1, stride=stride, bias=False, device=device)
            self.short_bn = _BnAffine(ch, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if hasattr(self, "short"):
            x = self.short_bn(self.short(x))
        return F.relu(x + h)


class WeSpeakerEmbedder(nn.Module):
    """(mel [S, T, n_mels], frame_weights [S, T_w]) -> embeddings [S, D] (f32)."""

    def __init__(self, cfg: WeSpeakerConfig = WeSpeakerConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.channels[0]
        self.stem = nn.Conv2d(1, c0, 3, padding=1, bias=False, device=device)
        self.stem_bn = _BnAffine(c0, device)
        c_in = c0
        for si, (ch, depth) in enumerate(zip(cfg.channels, cfg.blocks_per_stage)):
            for bi in range(depth):
                stride = 2 if (bi == 0 and si > 0) else 1
                self.add_module(f"s{si}b{bi}", _ResBlock(c_in, ch, stride, device))
                c_in = ch
        f_out = cfg.n_mels
        for _ in cfg.channels[1:]:
            f_out = (f_out - 1) // 2 + 1
        self.embed = nn.Linear(2 * f_out * c_in, cfg.embedding_dim, device=device)
        self.to(getattr(torch, cfg.dtype))

    @torch.no_grad()
    def forward(self, mel: torch.Tensor, frame_weights: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = self.stem.weight.dtype
        x = mel[:, None].to(dt)  # [S, 1, T, F]
        x = F.relu(self.stem_bn(self.stem(x)))
        for si, depth in enumerate(cfg.blocks_per_stage):
            for bi in range(depth):
                x = getattr(self, f"s{si}b{bi}")(x)
        S, C, T, Fq = x.shape
        feat = x.permute(0, 2, 3, 1).reshape(S, T, Fq * C)  # the JAX [S, T, F, C] order

        # mask-weighted statistics pooling over time (TSTP)
        w = frame_weights
        if w.shape[1] != T:
            # nearest-neighbour resample of the mask to the trunk's frame rate
            idx = torch.arange(T, device=w.device) * w.shape[1] // T
            w = w[:, idx]
        w = w.to(dt)[..., None]
        denom = torch.clamp(torch.sum(w, dim=1), min=1e-3)
        mean = torch.sum(feat * w, dim=1) / denom
        var = torch.sum((feat - mean[:, None, :]) ** 2 * w, dim=1) / denom
        stats = torch.cat([mean, torch.sqrt(var + 1e-6)], dim=-1)
        return self.embed(stats).float()


def make_fbank_frontend(device=None) -> MelFrontend:
    """80-mel fbank of the embedding path (reference FBank CoreML);
    `device=None` is the GPU."""
    return MelFrontend(MelConfig(n_mels=80, normalize=None), device=device)
