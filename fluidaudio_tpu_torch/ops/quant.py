"""Dynamic w8a8 int8 linear layers (weights quantised once, at load).

Port of `fluidaudio_tpu/ops/quant.py`:
  - weights: per-OUTPUT-channel symmetric scales (`quantize_cols`), computed
    once from the f32 weights (`quantize_linear_state`, the counterpart of
    `quantize_dense_tree`), so checkpoints stay plain f32 trees;
  - activations: per-ROW dynamic symmetric scales (`quantize_rows`);
  - int8 x int8 -> int32, dequantised as `acc * s_row * s_col (+ bias)` in
    f32, then cast to the compute dtype.

`Int8Linear` is the drop-in for `nn.Linear` (JAX `Int8Dense`); it runs
`ops/int8_matmul.py::int8_matmul_fused`, the hand-written kernel on a GPU.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from fluidaudio_tpu_torch.ops.int8_matmul import int8_matmul_fused, quantize_rows

__all__ = ["quantize_rows", "quantize_cols", "int8_matmul", "Int8Linear",
           "quantize_linear_state"]


def quantize_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[K, N] f32 -> (int8 [K, N], f32 scales [1, N]) per output channel."""
    wf = w.float()
    amax = wf.abs().amax(dim=0, keepdim=True)
    scale = torch.maximum(amax, torch.full_like(amax, 1e-8)) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_matmul(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Dynamic w8a8 x @ kernel ([K, N] f32, quantised here) -> f32 [..., N]."""
    shape = x.shape
    xq, sx = quantize_rows(x.reshape(-1, shape[-1]))
    wq, sw = quantize_cols(kernel)
    acc = xq.double() @ wq.double()  # exact: |acc| <= K * 127^2 < 2^53
    return (acc.float() * sx * sw).reshape(*shape[:-1], kernel.shape[-1])


class Int8Linear(nn.Module):
    """`nn.Linear` drop-in holding pre-quantised weights (JAX `Int8Dense`).

    Buffers: `weight_q` int8 [out, in], `weight_scale` f32 [out] and `bias`
    f32 [out] (or None). The scale and bias stay f32 through any
    `module.to(dtype)`: JAX keeps them f32 and adds the bias before the cast.
    The output is `out_dtype` (the model's compute dtype).
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 out_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.out_dtype = out_dtype
        self.register_buffer(
            "weight_q", torch.zeros(out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer(
            "weight_scale", torch.ones(out_features, dtype=torch.float32, device=device))
        self.register_buffer(
            "bias", torch.zeros(out_features, dtype=torch.float32, device=device) if bias
            else None)
        # the kernel's wrapper; a comparison may swap in the plain version
        self.matmul = int8_matmul_fused

    def _apply(self, fn, recurse=True):
        # move the f32 buffers with the module, but never change their dtype
        keep = {k: b for k, b in self._buffers.items()
                if b is not None and b.dtype == torch.float32}
        super()._apply(fn, recurse)
        for k, b in keep.items():
            moved = self._buffers[k]
            if moved.dtype != torch.float32:
                self._buffers[k] = b.to(moved.device)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        out = self.matmul(x.reshape(-1, shape[-1]).contiguous(), self.weight_q,
                          self.weight_scale, self.bias, self.out_dtype)
        return out.reshape(*shape[:-1], self.out_features)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}, out_dtype={self.out_dtype}")


def quantize_linear_state(state: Mapping[str, torch.Tensor | np.ndarray]
                          ) -> dict[str, torch.Tensor]:
    """Torch-layout state -> the `Int8Linear` layout: every 2-D `<name>.weight`
    [out, in] becomes `<name>.weight_q` int8 [out, in] and `<name>.weight_scale`
    f32 [out], quantised from its f32 values; every other entry passes through
    (as a tensor). Counterpart of JAX `quantize_dense_tree`."""
    out: dict[str, torch.Tensor] = {}
    for key, value in state.items():
        value = torch.as_tensor(value)
        prefix, dot, leaf = key.rpartition(".")
        if leaf == "weight" and value.ndim == 2:
            q, s = quantize_cols(value.T)
            out[f"{prefix}{dot}weight_q"] = q.T.contiguous()
            out[f"{prefix}{dot}weight_scale"] = s.reshape(-1)
        else:
            out[key] = value
    return out
