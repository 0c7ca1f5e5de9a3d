"""Batched greedy TDT / RNN-T decoding on the device, in PyTorch.

Port of `fluidaudio_tpu/ops/tdt_decode.py`. All rows of the batch advance
together under done-masks; the host only asks whether any row is still
active once every `ACTIVE_CHECK_EVERY` steps (one device sync per 8 steps,
never one per token). A step in which no row is active changes nothing, so
the extra steps before a check are exact no-ops.

Semantics kept from the JAX decoder:
  - joint predicts (token, duration-bin); time advances by the predicted
    duration for blank AND non-blank (TDT), with blank forcing >= 1 frame
  - the predictor (LSTM) only updates on non-blank emissions; its output is
    cached across blank steps
  - force-blank anti-livelock: after `max_symbols_per_step` emissions on one
    frame, time is force-advanced
  - decode state (h, c, last_token, time_jump) carries across chunks, with
    h/c held from BEFORE `last_token` was consumed
  - the last-chunk finalization flush for rows in `finalize_mask`
  - the optional `allowed_mask` script filter (`language_filter_rerank`)
  - `eou_id`: an end-of-utterance token is treated as blank and flagged
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, NamedTuple

import torch

ACTIVE_CHECK_EVERY = 8  # decode steps between host checks of any(active)

PredictorStep = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                         tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
JointLogits = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class TdtDecodeConfig:
    blank_id: int = 8192
    durations: tuple[int, ...] = (0, 1, 2, 3, 4)
    max_symbols_per_step: int = 10
    max_tokens: int = 512  # per window
    # last-chunk flush: stop probing after this many consecutive blanks
    consecutive_blank_limit: int = 5
    # end-of-utterance token: treated as blank for decode state, sets the
    # per-row eou_detected flag. None disables.
    eou_id: int | None = None


class TdtDecodeState(NamedTuple):
    """Per-row decoder state carried across windows. h/c hold the LSTM state
    from BEFORE `last_token` was consumed: the warm start re-runs
    `predictor_step(last_token, h, c)`."""

    h: torch.Tensor  # [L, B, H]
    c: torch.Tensor  # [L, B, H]
    last_token: torch.Tensor  # [B] int32 (blank == SOS)
    time_jump: torch.Tensor  # [B] int32: frames the previous window overshot


class TdtResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_tokens] int32 (padded with blank)
    token_times: torch.Tensor  # [B, max_tokens] int32 encoder frame of emission
    counts: torch.Tensor  # [B] int32 number of emitted tokens
    state: TdtDecodeState
    confidences: torch.Tensor  # [B, max_tokens] f32 token prob
    eou_detected: torch.Tensor = None  # [B] bool
    eou_frame: torch.Tensor = None  # [B] int32 frame of first EOU (-1 if none)
    durations: torch.Tensor = None  # [B, max_tokens] int32 predicted frames


def make_initial_state(cfg: TdtDecodeConfig, n_layers: int, hidden: int, batch: int,
                       dtype=torch.float32, device=None) -> TdtDecodeState:
    z = torch.zeros((n_layers, batch, hidden), dtype=dtype, device=device)
    return TdtDecodeState(
        h=z,
        c=z.clone(),
        last_token=torch.full((batch,), cfg.blank_id, dtype=torch.int32, device=device),
        time_jump=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def language_filter_rerank(
    token_logits: torch.Tensor,  # [B, V] (vocab incl. blank)
    k: torch.Tensor,  # [B] argmax token
    conf: torch.Tensor,  # [B] argmax prob
    allowed_mask: torch.Tensor,  # [V] bool: script-matching, non-blocklist tokens
    blank_id: int,
    top_k: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Replace a disallowed top-1 token with the best allowed top-K candidate.
    Blanks are never replaced nor chosen; with no allowed candidate in the
    top-K the prediction stands. Replacement confidence = softmax over the
    top-K logits."""
    top_k = min(top_k, token_logits.shape[-1])
    tk_logits, tk_ids = torch.topk(token_logits, top_k, dim=-1)  # [B, K]
    cand_ok = allowed_mask[tk_ids] & (tk_ids != blank_id)
    masked = torch.where(cand_ok, tk_logits, float("-inf"))
    best = torch.argmax(masked, dim=-1, keepdim=True)  # [B, 1]
    has_cand = torch.isfinite(masked.max(dim=-1).values)

    k = k.long()
    need_swap = (k != blank_id) & ~allowed_mask[k] & has_cand
    best_id = tk_ids.gather(1, best)[:, 0]
    new_k = torch.where(need_swap, best_id, k)

    tk_probs = torch.softmax(tk_logits.float(), dim=-1)
    best_prob = tk_probs.gather(1, best)[:, 0]
    new_conf = torch.where(need_swap, best_prob, conf)
    return new_k, new_conf


def _split_logits(logits, durations, n_dur):
    """-> (token_logits, duration of the argmax bin [B] int64)."""
    if n_dur > 0:
        return logits[:, :-n_dur], durations[torch.argmax(logits[:, -n_dur:], dim=-1)]
    return logits, torch.zeros(logits.shape[0], dtype=torch.long, device=logits.device)


def _record(c, emit, k, stamp, conf, dur, max_tokens: int) -> None:
    """Write (k, stamp, conf, dur) at each emitting row's next slot."""
    rows = torch.arange(emit.shape[0], device=emit.device)
    pos = c.count.clamp(0, max_tokens - 1)
    c.tokens[rows, pos] = torch.where(emit, k, c.tokens[rows, pos])
    c.times[rows, pos] = torch.where(emit, stamp, c.times[rows, pos])
    c.confs[rows, pos] = torch.where(emit, conf, c.confs[rows, pos])
    c.durs[rows, pos] = torch.where(emit, dur, c.durs[rows, pos])
    c.count = c.count + emit.long()


def _advance_predictor(c, emit, k, predictor_step: PredictorStep) -> None:
    """Run the predictor on emitting rows; keep the pre-consumption state."""
    new_token = torch.where(emit, k, c.last_token)
    g_new, h_new, c_new = predictor_step(new_token, c.h, c.c)
    sel = emit[:, None]
    sel3 = sel[None]
    c.g = torch.where(sel, g_new, c.g)
    c.prev_h = torch.where(sel3, c.h, c.prev_h)
    c.prev_c = torch.where(sel3, c.c, c.prev_c)
    c.h = torch.where(sel3, h_new, c.h)
    c.c = torch.where(sel3, c_new, c.c)
    c.last_token = new_token


def _main_step(cfg, c, enc, lengths, joint_logits, predictor_step, durations,
               n_dur, allowed_mask) -> None:
    B, T, _ = enc.shape
    rows = torch.arange(B, device=enc.device)
    active = (c.t < lengths) & (c.count < cfg.max_tokens)
    f = enc[rows, c.t.clamp(0, T - 1)]  # [B, D]

    token_logits, dur = _split_logits(joint_logits(f, c.g), durations, n_dur)
    k = torch.argmax(token_logits, dim=-1)
    probs = torch.softmax(token_logits.float(), dim=-1)
    conf = probs.gather(1, k[:, None])[:, 0]
    if allowed_mask is not None:
        k, conf = language_filter_rerank(token_logits, k, conf, allowed_mask, cfg.blank_id)

    force_blank = c.sym_count >= cfg.max_symbols_per_step
    if cfg.eou_id is not None:
        is_eou = (k == cfg.eou_id) & active
    else:
        is_eou = torch.zeros_like(active)
    is_blank = (k == cfg.blank_id) | force_blank | ~active | is_eou
    emit = ~is_blank

    _record(c, emit, k, c.t, conf, dur, cfg.max_tokens)
    _advance_predictor(c, emit, k, predictor_step)

    if n_dur > 0:
        adv = torch.where(is_blank, dur.clamp(min=1), dur)  # blank always moves on
    else:
        adv = is_blank.long()  # classic RNN-T
    adv = torch.where(force_blank, adv.clamp(min=1), adv)
    adv = torch.where(active, adv, 0)
    c.eou_frame = torch.where(is_eou & (c.eou_frame < 0), c.t, c.eou_frame)
    c.eou = c.eou | is_eou
    c.t = c.t + adv
    c.sym_count = torch.where(adv > 0, 0, c.sym_count + emit.long())


def _finalize_last_chunk(cfg, c, enc, lengths, finalize_mask, joint_logits,
                         predictor_step, durations, n_dur) -> None:
    """Last-chunk flush, batched: probe up to `max_symbols_per_step` extra
    joint steps per finalized row, cycling the frame between [current,
    eff-1, eff-2] (clamped to the row's real frames); `consecutive_blank_limit`
    blanks in a row end the row; non-blanks emit with timestamp
    min(t, eff-1) and advance by max(1, duration) clamped to eff."""
    B, T, _ = enc.shape
    rows = torch.arange(B, device=enc.device)
    eff = lengths.clamp(1, T)
    steps = torch.zeros_like(c.count)
    blanks = torch.zeros_like(c.count)

    def fin_active():
        return (finalize_mask & (steps < cfg.max_symbols_per_step)
                & (blanks < cfg.consecutive_blank_limit) & (c.count < cfg.max_tokens))

    step = 0
    while True:
        active = fin_active()
        if step % ACTIVE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        step += 1
        v0 = torch.minimum(c.t.clamp(min=0), eff - 1)
        v1 = (eff - 1).clamp(0, T - 1)
        v2 = (eff - 2).clamp(0, T - 1)
        variations = torch.stack([v0, v1, v2], dim=-1)  # [B, 3]
        frame = variations.gather(1, (steps % 3)[:, None])[:, 0]
        f = enc[rows, frame]

        token_logits, dur = _split_logits(joint_logits(f, c.g), durations, n_dur)
        k = torch.argmax(token_logits, dim=-1)
        probs = torch.softmax(token_logits.float(), dim=-1)
        conf = probs.gather(1, k[:, None])[:, 0].clamp(0.0, 1.0)

        is_blank_tok = k == cfg.blank_id
        if cfg.eou_id is not None:  # EOU never emits from the flush
            is_blank_tok = is_blank_tok | (k == cfg.eou_id)
        emit = active & ~is_blank_tok

        _record(c, emit, k, torch.minimum(c.t, eff - 1), conf, dur, cfg.max_tokens)
        _advance_predictor(c, emit, k, predictor_step)

        blanks = torch.where(emit, 0, blanks + (active & is_blank_tok).long())
        c.t = torch.where(active, torch.minimum(c.t + dur.clamp(min=1), eff), c.t)
        steps = steps + active.long()


@torch.no_grad()
def tdt_greedy_decode(
    cfg: TdtDecodeConfig,
    predictor_step: PredictorStep,
    joint_logits: JointLogits,
    encoder_out: torch.Tensor,  # [B, T, D] float
    encoder_lengths: torch.Tensor,  # [B] int
    state: TdtDecodeState | None = None,
    allowed_mask: torch.Tensor | None = None,  # [V] bool language filter
    finalize_mask: torch.Tensor | None = None,  # [B] bool: row is a last chunk
) -> TdtResult:
    """Greedy TDT decode over a batch of encoder outputs.

    `predictor_step(tokens, h, c) -> (g, h', c')`; `joint_logits(f, g) ->
    [B, vocab+1+n_dur]`. Rows in `finalize_mask` run the last-chunk flush
    after the main loop and return `time_jump == 0`. The flush never applies
    the language filter.
    """
    if state is None:
        raise ValueError("pass an explicit initial state (make_initial_state)")
    B, T, _ = encoder_out.shape
    dev = encoder_out.device
    n_dur = len(cfg.durations)
    durations = torch.tensor(cfg.durations, dtype=torch.long, device=dev)
    lengths = encoder_lengths.to(device=dev, dtype=torch.long)

    last_token = state.last_token.to(device=dev, dtype=torch.long)
    g0, h0, c0 = predictor_step(last_token, state.h, state.c)
    c = SimpleNamespace(
        t=state.time_jump.to(device=dev, dtype=torch.long).clamp(min=0),
        h=h0, c=c0, g=g0, prev_h=state.h, prev_c=state.c, last_token=last_token,
        sym_count=torch.zeros(B, dtype=torch.long, device=dev),
        tokens=torch.full((B, cfg.max_tokens), cfg.blank_id, dtype=torch.long, device=dev),
        times=torch.zeros((B, cfg.max_tokens), dtype=torch.long, device=dev),
        confs=torch.zeros((B, cfg.max_tokens), dtype=torch.float32, device=dev),
        durs=torch.zeros((B, cfg.max_tokens), dtype=torch.long, device=dev),
        count=torch.zeros(B, dtype=torch.long, device=dev),
        eou=torch.zeros(B, dtype=torch.bool, device=dev),
        eou_frame=torch.full((B,), -1, dtype=torch.long, device=dev),
    )

    step = 0
    while True:
        if step % ACTIVE_CHECK_EVERY == 0:
            active = (c.t < lengths) & (c.count < cfg.max_tokens)
            if not bool(active.any()):
                break
        _main_step(cfg, c, encoder_out, lengths, joint_logits, predictor_step,
                   durations, n_dur, allowed_mask)
        step += 1

    if finalize_mask is not None:
        finalize_mask = finalize_mask.to(device=dev, dtype=torch.bool)
        _finalize_last_chunk(cfg, c, encoder_out, lengths, finalize_mask, joint_logits,
                             predictor_step, durations, n_dur)

    # frames the decode overshot past this window's end, carried to the next
    time_jump = (c.t - lengths).clamp(min=0)
    if finalize_mask is not None:
        time_jump = torch.where(finalize_mask, 0, time_jump)

    i32 = torch.int32
    return TdtResult(
        tokens=c.tokens.to(i32),
        token_times=c.times.to(i32),
        counts=c.count.to(i32),
        state=TdtDecodeState(c.prev_h, c.prev_c, c.last_token.to(i32), time_jump.to(i32)),
        confidences=c.confs,
        eou_detected=c.eou,
        eou_frame=c.eou_frame.to(i32),
        durations=c.durs.to(i32),
    )
