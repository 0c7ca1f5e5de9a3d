"""Transducer losses in torch: RNN-T and TDT (token-and-duration).

Port of `fluidaudio_tpu/train/transducer_loss.py`, the losses the shipped
NeMo checkpoints were trained with:

- `rnnt_loss`: log-domain forward DP over the (T, U) lattice, one step per
  frame. The intra-frame recurrence
  `alpha_t[u] = logaddexp(base[u], alpha_t[u-1] + emit[u-1])` is solved in
  one `torch.logcumsumexp` with the prefix trick
  (alpha = C + logcumsumexp(base - C), C = shifted cumsum of emit).
- `tdt_loss`: the generalisation with per-step duration distributions (Xu
  et al., TDT). Token emissions may carry duration 0 (stay on the frame),
  which keeps the intra-frame recurrence; blanks must advance (duration >=
  1). Each frame reads the alpha rows of the last `max(durations)` frames.

The frames are a Python loop in place of `lax.scan`: every step is a few
tensor ops on the inputs' device and none reads a value back, so the loop
makes no host sync. Autograd differentiates both losses. Masking uses
JAX's `NEG = -1e30` and its order of sums: cells past a row's label count
hold cancellation garbage (`C` about -1e30 against `base - C` about +1e30)
that no valid cell reads, so their gradients are exact zeros.
"""

from __future__ import annotations

import torch

NEG = -1e30


def _log_cum_prefix(base: torch.Tensor, emit: torch.Tensor) -> torch.Tensor:
    """Solve x[u] = logaddexp(base[u], x[u-1] + emit[u-1]) for u = 0..U
    (x[-1] = -inf) along the last axis.

    base [..., U1], emit [..., U1] (emit[..., U1-1] unused). Returns x."""
    # C[u] = sum_{j<u} emit[j]
    C = torch.cumsum(torch.cat([torch.zeros_like(emit[..., :1]), emit[..., :-1]], dim=-1),
                     dim=-1)
    # x[u] = C[u] + logsumexp_{k<=u}(base[k] - C[k])
    return C + torch.logcumsumexp(base - C, dim=-1)


def _emit_scores(log_probs: torch.Tensor, labels: torch.Tensor,
                 u_lengths: torch.Tensor) -> torch.Tensor:
    """[B, T, U+1]: the log-prob of emitting label u at (t, u); NEG at
    u >= u_lengths (and at the unused column U)."""
    B, T, U1, _ = log_probs.shape
    lab = torch.cat([labels.long(), labels.new_zeros((B, 1), dtype=torch.long)], dim=1)
    emit = torch.gather(log_probs, 3, lab[:, None, :, None].expand(B, T, U1, 1))[..., 0]
    u_idx = torch.arange(U1, device=log_probs.device)
    return torch.where(u_idx[None, None, :] < u_lengths.to(log_probs.device)[:, None, None],
                       emit, NEG)


def rnnt_loss(
    log_probs: torch.Tensor,  # [B, T, U+1, V] log-softmaxed joint outputs
    labels: torch.Tensor,  # [B, U] int
    t_lengths: torch.Tensor,  # [B]
    u_lengths: torch.Tensor,  # [B] label counts
    blank_id: int,
) -> torch.Tensor:
    """Negative log-likelihood per batch row [B]."""
    B, T, U1, V = log_probs.shape
    dev = log_probs.device
    t_lengths = t_lengths.to(dev).long()
    u_lengths = u_lengths.to(dev).long()

    blank = log_probs[..., blank_id]  # [B, T, U+1]
    emit = _emit_scores(log_probs, labels, u_lengths)

    # row t = 0 from the start state, then each row from the previous one's
    # blank move (scores at frame t-1) and this frame's emits
    alpha0_base = torch.full((B, U1), NEG, dtype=log_probs.dtype, device=dev)
    alpha0_base[:, 0] = 0.0
    alpha = _log_cum_prefix(alpha0_base, emit[:, 0])
    alphas = [alpha]
    for t in range(1, T):
        alpha = _log_cum_prefix(alpha + blank[:, t - 1], emit[:, t])
        alphas.append(alpha)
    alphas = torch.stack(alphas)  # [T, B, U+1]

    # terminate: alpha[T_b - 1, U_b] + blank(T_b - 1, U_b)
    rows = torch.arange(B, device=dev)
    t_last = t_lengths - 1
    alpha_end = alphas[t_last, rows, u_lengths]
    blank_end = blank[rows, t_last, u_lengths]
    return -(alpha_end + blank_end)


def tdt_loss(
    token_log_probs: torch.Tensor,  # [B, T, U+1, V] log-softmax over tokens
    dur_log_probs: torch.Tensor,  # [B, T, U+1, D] log-softmax over durations
    durations: tuple[int, ...],  # e.g. (0, 1, 2, 3, 4)
    labels: torch.Tensor,  # [B, U]
    t_lengths: torch.Tensor,
    u_lengths: torch.Tensor,
    blank_id: int,
) -> torch.Tensor:
    """TDT negative log-likelihood per row [B]. Blank transitions must advance
    time (duration 0 blank is excluded, as in NeMo's TDT implementation)."""
    B, T, U1, V = token_log_probs.shape
    D = len(durations)
    if dur_log_probs.shape[-1] != D:
        raise ValueError(f"dur_log_probs has {dur_log_probs.shape[-1]} bins, durations {D}")
    dev, dt = token_log_probs.device, token_log_probs.dtype
    t_lengths = t_lengths.to(dev).long()
    u_lengths = u_lengths.to(dev).long()

    blank = token_log_probs[..., blank_id]
    emit = _emit_scores(token_log_probs, labels, u_lengths)
    max_d = max(durations)
    # duration 0 may sit anywhere in the bins tuple; indexing bin 0 for it
    # would silently drop every zero-duration emission from the lattice
    zero_idx = durations.index(0) if 0 in durations else -1
    neg_row = torch.full((B, U1), NEG, dtype=dt, device=dev)
    neg_col = neg_row[:, :1]

    # window[d - 1] holds the alpha row of frame t - d
    window = [neg_row] * max_d
    alphas = []
    for t in range(T):
        # contributions landing exactly on frame t from earlier frames (a
        # source before frame 0 contributes nothing: JAX masks it out)
        base = neg_row
        for di, d in enumerate(durations):
            if d == 0 or t - d < 0:
                continue
            src = t - d
            a_src = window[d - 1]
            dur = dur_log_probs[:, src, :, di]
            base_blank = a_src + (blank[:, src] + dur)
            base_emit_shift = torch.cat([neg_col, (a_src + (emit[:, src] + dur))[:, :-1]], dim=1)
            base = torch.logaddexp(base, torch.logaddexp(base_blank, base_emit_shift))
        if t == 0:
            base = torch.cat([torch.zeros_like(neg_col), base[:, 1:]], dim=1)
        # duration-0 token emissions within frame t
        if zero_idx >= 0:
            alpha_t = _log_cum_prefix(base, emit[:, t] + dur_log_probs[:, t, :, zero_idx])
        else:
            alpha_t = base
        window = [alpha_t] + window[:-1]
        alphas.append(alpha_t)
    alphas = torch.stack(alphas)  # [T, B, U+1]

    # terminate: from (t, U) take a blank whose duration jumps exactly to T_b
    rows = torch.arange(B, device=dev)
    end = torch.full((B,), NEG, dtype=dt, device=dev)
    for di, d in enumerate(durations):
        if d == 0:
            continue
        t_src = t_lengths - d  # frame whose blank + duration d lands on T
        ts = torch.clamp(t_src, min=0)
        a_u = alphas[ts, rows, u_lengths]
        b = blank[rows, ts, u_lengths]
        dd = dur_log_probs[rows, ts, u_lengths, di]
        end = torch.where(t_src >= 0, torch.logaddexp(end, a_u + b + dd), end)
    return -end
