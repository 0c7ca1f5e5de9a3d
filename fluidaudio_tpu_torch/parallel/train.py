"""Training steps: CTC fine-tuning of the encoder, and the full TDT transducer.

Port of `fluidaudio_tpu/parallel/train.py`. The loss of the CTC step is
optax's `ctc_loss` over encoder outputs (`ctc_loss` below, the same
numbers: a row no alignment fits gets a finite loss from `log_epsilon`,
where `F.ctc_loss` gives inf, or 0 with `zero_infinity`), the mean over the
batch. The TDT step teacher-forces the predictor over `[blank] + labels`,
takes the joint in broadcast form `[B, T, U+1, V+D]`, log-softmaxes the
token and duration halves in f32 and takes `train.tdt_loss`. The optimizer
is `AdamW`, `optax.adamw(lr)`'s update.

Parameters are f32 (flax keeps its parameters in f32; a bf16-compute or
int8 config is refused) and live in `TrainState.params`, a dict of dotted
names (`encoder.block0.mhsa.q.weight`, `ctc_head`, `predictor.embedding`,
`joint.out.weight`) to tensors: the modules' own parameters, or the
`DTensor`s of `parallel.mesh.shard_params`. A step runs the modules with
those tensors (`torch.func.functional_call`) under autograd. The encoder
routes attention as JAX's encoder does under `jax.grad`
(`ConformerEncoder.attention_route`): the plain version, never a kernel.

The `jit_*` names are kept for their JAX counterparts and return plain
callables (no compilation). Under a mesh every rank runs the step on its
rows of the global batch: each parameter is gathered over "model" for the
forward (the gather's backward gives each rank the gradient of its part),
and the loss and gradients are averaged over "data" (JAX's loss is the
mean over the global batch). The optimizer state is placed like its
parameter, as JAX's `_opt_state_shardings` places it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.func import functional_call
from torch.nn import functional as F

from fluidaudio_tpu_torch.models.conformer import ConformerConfig, ConformerEncoder
from fluidaudio_tpu_torch.models.predictor import PredictorConfig, RnntJoint, RnntPredictor
from fluidaudio_tpu_torch.models.zoo import random_init_
from fluidaudio_tpu_torch.parallel.mesh import (
    axis_size,
    full,
    local,
    mesh_device,
    shard_batch,
    shard_params,
)
from fluidaudio_tpu_torch.train.transducer_loss import tdt_loss
from fluidaudio_tpu_torch.utils.device import resolve_device

BATCH_KEYS = ("mel", "mel_lengths", "labels", "label_lengths")


# --------------------------------------------------------------- optimizer


class AdamWState(NamedTuple):
    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclass(frozen=True)
class AdamW:
    """`optax.adamw(learning_rate)` with optax's defaults: scale_by_adam (b1
    0.9, b2 0.999, eps 1e-8, bias-corrected), plus 1e-4 times the parameter
    (weight decay on every parameter; torch's `AdamW` decays by 1e-2 by
    default), times -learning_rate."""

    learning_rate: float
    b1 = 0.9
    b2 = 0.999
    eps = 1e-8
    weight_decay = 1e-4

    def init(self, params: dict[str, torch.Tensor]) -> AdamWState:
        """Zero moments shaped and placed like the parameters."""
        return AdamWState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                          {k: torch.zeros_like(v) for k, v in params.items()})

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: AdamWState,
               params: dict[str, torch.Tensor]) -> tuple[dict[str, torch.Tensor], AdamWState]:
        """-> (updates, state): the moments are updated in place (on each
        rank's part of a `DTensor`); the updates are new tensors (parts)."""
        names = list(params)
        g = [local(grads[k]) for k in names]
        mu = [local(state.mu[k]) for k in names]
        nu = [local(state.nu[k]) for k in names]
        p = [local(params[k]) for k in names]
        count = state.count + 1
        # mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu (optax's order)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2))
        # optax's bias corrections, 1 - decay**count, are f32
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_add_(u, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(u, -self.learning_rate)
        return dict(zip(names, u)), AdamWState(count, state.mu, state.nu)


@torch.no_grad()
def apply_updates(params: dict[str, torch.Tensor], updates: dict[str, torch.Tensor]) -> None:
    """params += updates, in place (`optax.apply_updates`)."""
    names = list(params)
    torch._foreach_add_([local(params[k]) for k in names], [updates[k] for k in names])


# -------------------------------------------------------------------- CTC


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor, labels: torch.Tensor,
             label_paddings: torch.Tensor, blank_id: int = 0,
             log_epsilon: float = -1e5) -> torch.Tensor:
    """`optax.ctc_loss`: per-sequence CTC negative log-likelihood [B] of
    logits [B, T, K] (log-softmaxed here) with 1.0 marking padded frames
    and (right-)padded labels. Impossible transitions score `log_epsilon`,
    so every row's loss is finite."""
    B, T, K = logits.shape
    N = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = N - label_paddings.sum(dim=1).to(torch.int64)
    # repeat[b, n] == 1.0 when label[b, n] == label[b, n+1]
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logits.dtype), (0, 1))
    logprobs_phi = logprobs[:, :, blank_id:blank_id + 1].transpose(0, 1)  # [T, B, 1]
    logprobs_emit = torch.gather(logprobs, 2, labels.long()[:, None, :].expand(B, T, N))
    logprobs_emit = logprobs_emit.transpose(0, 1)  # [T, B, N]
    pads = logit_paddings.transpose(0, 1).to(logits.dtype)[..., None]  # [T, B, 1]

    phi = torch.full((B, N + 1), log_epsilon, dtype=logits.dtype, device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), log_epsilon, dtype=logits.dtype, device=logits.device)

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=-1)

    for t in range(T):
        prev_phi_orig = phi
        # emit-to-phi epsilon transition, except if the next label is a repetition
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)
        lp_emit, lp_phi, pad = logprobs_emit[t], logprobs_phi[t], pads[t]
        # phi-to-emit transition
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        # self-loop transition
        next_phi = prev_phi + lp_phi
        # emit-to-phi blank transition only when the next label is a repetition
        next_phi = update_phi(next_phi, emit + lp_phi + log_epsilon * (1.0 - repeat))
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi

    # the last row takes the last epsilon transition
    phi_last = update_phi(phi, emit)
    return -torch.gather(phi_last, 1, labellens[:, None])[:, 0]


def _sub(params: dict[str, torch.Tensor], prefix: str) -> dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


class CtcObjective:
    """The CTC step's loss of a batch: `outputs` (encoder, then the CTC
    head: logits [B, T, V+1] and encoder lengths) and `loss` (the mean
    of `ctc_loss`)."""

    def __init__(self, encoder: ConformerEncoder, blank_id: int):
        self.encoder, self.blank_id = encoder, blank_id

    def outputs(self, params, batch):
        enc, enc_lengths = functional_call(self.encoder, _sub(params, "encoder."),
                                           (batch["mel"], batch["mel_lengths"]))
        return enc @ params["ctc_head"], enc_lengths

    def loss(self, outputs, batch):
        logits, enc_lengths = outputs
        B, T, _ = logits.shape
        labels, label_lengths = batch["labels"], batch["label_lengths"]
        dev = logits.device
        logit_pad = (torch.arange(T, device=dev)[None, :]
                     >= enc_lengths.to(dev)[:, None]).to(torch.float32)
        label_pad = (torch.arange(labels.shape[1], device=dev)[None, :]
                     >= label_lengths.to(dev)[:, None]).to(torch.float32)
        return ctc_loss(logits, logit_pad, labels, label_pad, blank_id=self.blank_id).mean()

    def __call__(self, params, batch):
        return self.loss(self.outputs(params, batch), batch)


class TdtObjective:
    """The TDT step's loss of a batch: `outputs` (encoder; the predictor
    teacher-forced over `[blank] + labels`, U+1 steps; the joint in
    broadcast form; token and duration log-softmax in f32) and `loss` (the
    mean of `tdt_loss`)."""

    def __init__(self, modules, pcfg: PredictorConfig, durations: tuple[int, ...]):
        self.encoder, self.predictor, self.joint = modules
        self.pcfg, self.durations = pcfg, tuple(durations)

    def outputs(self, params, batch):
        pcfg = self.pcfg
        enc, enc_lengths = functional_call(self.encoder, _sub(params, "encoder."),
                                           (batch["mel"], batch["mel_lengths"]))
        B = enc.shape[0]
        labels = batch["labels"].to(enc.device)
        tokens_in = torch.cat([torch.full((B, 1), pcfg.blank_id, dtype=torch.long,
                                          device=enc.device), labels.long()], dim=1)
        pred = _sub(params, "predictor.")
        h = c = torch.zeros((pcfg.n_layers, B, pcfg.pred_hidden), dtype=enc.dtype,
                            device=enc.device)
        gs = []
        for u in range(tokens_in.shape[1]):
            g, h, c = functional_call(self.predictor, pred, (tokens_in[:, u], h, c))
            gs.append(g)
        g = torch.stack(gs, dim=1)  # [B, U+1, H]
        logits = functional_call(self.joint, _sub(params, "joint."),
                                 (enc[:, :, None, :], g[:, None, :, :]))  # [B, T, U+1, V+D]
        V = pcfg.num_token_logits
        tok_lp = torch.log_softmax(logits[..., :V].float(), dim=-1)
        dur_lp = torch.log_softmax(logits[..., V:].float(), dim=-1)
        return tok_lp, dur_lp, enc_lengths

    def loss(self, outputs, batch):
        tok_lp, dur_lp, enc_lengths = outputs
        return tdt_loss(tok_lp, dur_lp, self.durations, batch["labels"], enc_lengths,
                        batch["label_lengths"], self.pcfg.blank_id).mean()

    def __call__(self, params, batch):
        return self.loss(self.outputs(params, batch), batch)


# ----------------------------------------------------------------- states


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor]
    opt_state: AdamWState
    step: int


class TransducerTrainState(NamedTuple):
    params: dict[str, torch.Tensor]
    opt_state: AdamWState
    step: int


def _trainable(cfg: ConformerConfig) -> None:
    if cfg.quantization != "none":
        raise ValueError(f"quantization={cfg.quantization!r} is not trainable (nor in JAX); "
                         "train the float32 encoder")
    if cfg.dtype != "float32":
        raise ValueError(f"dtype={cfg.dtype!r}: the port trains in dtype=\"float32\" only "
                         "(JAX keeps float32 parameters and computes in the config's dtype)")


def create_train_state(generator: torch.Generator, cfg: ConformerConfig, vocab_size: int,
                       mel_frames: int, learning_rate: float = 1e-4, *,
                       device: torch.device | str | None = None,
                       ) -> tuple[TrainState, ConformerEncoder, AdamW]:
    """Init the encoder and the CTC head `[d_model, vocab_size + 1]`
    (randn * 0.02) from `generator` (on `device`, the card by default), and
    AdamW. `mel_frames` is JAX's init shape; torch needs none."""
    del mel_frames
    _trainable(cfg)
    device = resolve_device(device)
    encoder = ConformerEncoder(cfg, device=device)
    random_init_(encoder, generator)
    head = torch.randn((cfg.d_model, vocab_size + 1), generator=generator,
                       device=device) * 0.02
    params = {f"encoder.{k}": v for k, v in encoder.named_parameters()}
    params["ctc_head"] = head.requires_grad_(True)
    tx = AdamW(learning_rate)
    return TrainState(params, tx.init(params), 0), encoder, tx


def create_tdt_train_state(generator: torch.Generator, ccfg: ConformerConfig,
                           pcfg: PredictorConfig, mel_frames: int,
                           learning_rate: float = 1e-4, *,
                           device: torch.device | str | None = None):
    """Init the full TDT stack (encoder + predictor + joint) from `generator`
    and AdamW. -> (state, (encoder, predictor, joint), tx)."""
    del mel_frames
    _trainable(ccfg)
    if pcfg.dtype != "float32":
        raise ValueError(f"predictor dtype={pcfg.dtype!r}: train in dtype=\"float32\"")
    device = resolve_device(device)
    modules = (ConformerEncoder(ccfg, device=device), RnntPredictor(pcfg, device=device),
               RnntJoint(pcfg, device=device))
    params = {}
    for name, module in zip(("encoder", "predictor", "joint"), modules):
        random_init_(module, generator)
        params.update({f"{name}.{k}": v for k, v in module.named_parameters()})
    tx = AdamW(learning_rate)
    return TransducerTrainState(params, tx.init(params), 0), modules, tx


# ------------------------------------------------------------------ steps


def _batch_tensors(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """This rank's rows of each field, on `device`."""
    return {k: local(torch.as_tensor(batch[k])).to(device) for k in BATCH_KEYS}


def loss_and_grads(objective, params: dict[str, torch.Tensor], batch: dict, mesh=None
                   ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """`jax.value_and_grad` of an objective: (loss, {name: gradient}). Under
    a mesh, `batch` holds this rank's rows (`shard_batch`) and both are
    averaged over "data", the mean over the global batch; each gradient
    is placed like its parameter."""
    names = list(params)
    leaves = [params[k] for k in names]
    full_params = {k: full(v) for k, v in zip(names, leaves)}
    device = next(iter(full_params.values())).device
    loss = objective(full_params, _batch_tensors(batch, device))
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.detach()
    if mesh is not None and axis_size(mesh, "data") > 1:
        parts = [loss[None]] + [local(g) for g in grads]
        flat = _flatten_dense_tensors(parts)
        dist.all_reduce(flat, group=mesh.get_group("data"))
        flat /= axis_size(mesh, "data")
        for part, synced in zip(parts, _unflatten_dense_tensors(flat, parts)):
            part.copy_(synced)
    return loss, dict(zip(names, grads))


def _step(objective, tx: AdamW, state_cls, mesh=None):
    def train_step(state, batch: dict):
        loss, grads = loss_and_grads(objective, state.params, batch, mesh)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        apply_updates(state.params, updates)
        return state_cls(state.params, opt_state, state.step + 1), {"loss": loss}

    return train_step


def make_train_step(encoder: ConformerEncoder, tx: AdamW, blank_id: int):
    """(state, batch) -> (state, {"loss"}): one CTC step on one device.
    `batch` holds `mel`, `mel_lengths`, `labels`, `label_lengths` (numpy or
    tensors). The state's parameters and moments are updated in place."""
    return _step(CtcObjective(encoder, blank_id), tx, TrainState)


def make_tdt_train_step(modules, pcfg: PredictorConfig, tx: AdamW,
                        durations: tuple[int, ...]):
    """(state, batch) -> (state, {"loss"}): one TDT step on one device."""
    return _step(TdtObjective(modules, pcfg, durations), tx, TransducerTrainState)


def _placed(mesh, state):
    """The state with its parameters placed by the sharding rules (those not
    yet `DTensor`s) and each moment placed like its parameter (JAX's
    `in_shardings`; a no-op once placed)."""
    params = state.params
    if not all(isinstance(v, DTensor) for v in params.values()):
        params = shard_params(mesh, params)

    def like(moments):
        return {k: v if isinstance(v, DTensor) else
                distribute_tensor(v.to(mesh_device(mesh)), mesh, list(params[k].placements))
                for k, v in moments.items()}

    opt = state.opt_state
    return state._replace(params=params,
                          opt_state=opt._replace(mu=like(opt.mu), nu=like(opt.nu)))


def _sharded(mesh, step):
    def sharded_step(state, batch: dict):
        batch = {k: v if isinstance(v, DTensor) else shard_batch(mesh, v)
                 for k, v in batch.items() if k in BATCH_KEYS}
        return step(_placed(mesh, state), batch)

    return sharded_step


def jit_sharded_train_step(mesh, encoder: ConformerEncoder, tx: AdamW, blank_id: int,
                           state: TrainState):
    """The CTC step with the batch over "data" and the parameters and moments
    placed by `param_sharding_rules` over "model". `state` is JAX's argument
    for the shardings; the step places whatever state it is given."""
    del state
    return _sharded(mesh, _step(CtcObjective(encoder, blank_id), tx, TrainState, mesh))


def jit_sharded_tdt_train_step(mesh, modules, pcfg: PredictorConfig, tx: AdamW,
                               durations: tuple[int, ...], state: TransducerTrainState):
    """The TDT step with the batch over "data" and the parameters and moments
    placed by `param_sharding_rules` over "model"."""
    del state
    return _sharded(mesh, _step(TdtObjective(modules, pcfg, durations), tx,
                                TransducerTrainState, mesh))
