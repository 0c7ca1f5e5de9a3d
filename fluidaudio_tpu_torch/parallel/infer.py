"""Mesh-sharded batch inference: encoder forward + greedy TDT decode.

Port of `fluidaudio_tpu/parallel/infer.py`, the serving-side counterpart of
`parallel/train.py`: batch rows shard over "data" (the reference's
worker-pool data parallelism as a sharded batch dimension). Each rank runs
the serving encoder on its rows (the attention kernel at Dh 128 on the
card, under `torch.no_grad`) and `ops.tdt_decode.tdt_greedy_decode`, then
the outputs are all-gathered over "data", so every rank holds the whole
batch's result.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.func import functional_call

from fluidaudio_tpu_torch.ops.tdt_decode import (
    TdtDecodeConfig,
    make_initial_state,
    tdt_greedy_decode,
)
from fluidaudio_tpu_torch.parallel.mesh import full, gather_rows, local_rows, mesh_device


def jit_sharded_infer(mesh, modules, pcfg, params,
                      durations: tuple[int, ...] = (0, 1, 2, 3, 4)):
    """An (encoder -> TDT greedy decode) forward over the mesh.

    Returns `infer(params, mel, mel_lengths) -> (tokens [B, 64], counts
    [B], enc_lengths [B])` for the whole batch on every rank. `mel` and
    `mel_lengths` are the global batch (numpy, tensors, or `DTensor`s from
    `shard_batch`); `params` maps dotted names (`encoder.…`, `predictor.…`,
    `joint.…`) to tensors or `DTensor`s. `params` here is JAX's argument for
    the shardings; `infer` uses the ones it is given."""
    del params
    encoder, predictor, joint = modules
    dcfg = TdtDecodeConfig(blank_id=pcfg.blank_id, durations=tuple(durations), max_tokens=64)
    device = mesh_device(mesh)

    def rows(x):
        if isinstance(x, DTensor):
            return x.to_local().to(device)
        x = torch.as_tensor(x).to(device)
        return x[local_rows(mesh, x.shape[0])]

    @torch.no_grad()
    def infer(params, mel, mel_lengths):
        full_params = {k: full(v) for k, v in params.items()}

        def part(prefix):
            return {k[len(prefix):]: v for k, v in full_params.items() if k.startswith(prefix)}

        enc_p, pred_p, joint_p = part("encoder."), part("predictor."), part("joint.")
        enc, enc_lengths = functional_call(encoder, enc_p, (rows(mel), rows(mel_lengths)))
        state = make_initial_state(dcfg, pcfg.n_layers, pcfg.pred_hidden, enc.shape[0],
                                   dtype=enc.dtype, device=device)
        result = tdt_greedy_decode(
            dcfg, lambda t, h, c: functional_call(predictor, pred_p, (t, h, c)),
            lambda f, g: functional_call(joint, joint_p, (f, g)), enc, enc_lengths, state)
        return (gather_rows(mesh, result.tokens), gather_rows(mesh, result.counts),
                gather_rows(mesh, enc_lengths))

    return infer

