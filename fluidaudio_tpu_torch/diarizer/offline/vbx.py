"""VBx clustering: variational EM over rho features (diagonal PLDA).

Port of `fluidaudio_tpu/diarizer/offline/vbx.py` (reference
`Offline/Clustering/VBxClustering.swift:6-100,167,685`, BUT VBx): gamma
responsibilities, pi weights, ELBO convergence, Fa/Fb scaling, and
`refine_with_constraints` honoring num/min/max speakers via
`SpeakerCountConstraints`.

Model: rho_n ~ N(V z_s, I) with V = diag(sqrt(psi)), z_s ~ N(0, I), and a
sticky HMM over the frame sequence (stay prob = loop_probability, uniform
switching) smoothing the responsibilities via forward-backward.

It runs on the host in f32 numpy, in the JAX iteration's order (its two
`lax.scan`s become two loops over the N embeddings, its logsumexp subtracts
the max the same way): N is a few hundred per recording and the loops are
sequential, which a device would run as thousands of tiny launches.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fluidaudio_tpu_torch.diarizer.offline.types import VBxOptions
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("diarizer.vbx")

_F32 = np.float32


@dataclass
class VBxResult:
    labels: np.ndarray  # [N] hard assignment
    gamma: np.ndarray  # [N, S]
    pi: np.ndarray  # [S]
    elbo_trace: list[float]
    # VBxConstraintTests contract: whether speaker-count constraints changed
    # the clustering, and how many clusters VBx found before adjustment
    adjusted: bool = False
    original_cluster_count: int | None = None


def _logsumexp(a: np.ndarray, axis: int, keepdims: bool = False) -> np.ndarray:
    """f32 logsumexp as `jax.scipy.special.logsumexp` computes it: the max
    subtracted (a non-finite max taken as 0), then added back."""
    amax = np.max(a, axis=axis, keepdims=True)
    amax = np.where(np.isfinite(amax), amax, _F32(0.0))
    out = np.log(np.sum(np.exp(a - amax), axis=axis, keepdims=True)) + amax
    return out if keepdims else np.squeeze(out, axis=axis)


def _hmm_forward_backward(log_p: np.ndarray, log_pi: np.ndarray, loop_prob: float
                          ) -> tuple[np.ndarray, np.float32]:
    """Sticky-HMM smoothing of per-frame speaker log-likelihoods.

    log_p [N, S] (already Fa/Fb-scaled), log_pi [S] -> (gamma [N, S],
    log-evidence scalar). Transition: stay with `loop_prob`, switch uniformly.
    """
    N, S = log_p.shape
    stay = np.log(_F32(loop_prob))
    switch = np.log(np.maximum(_F32(1.0 - loop_prob) / _F32(max(S - 1, 1)), _F32(1e-10)))
    log_a = np.full((S, S), switch, _F32)
    np.fill_diagonal(log_a, stay)

    alphas = np.empty((N, S), _F32)
    alphas[0] = log_pi + log_p[0]
    for t in range(1, N):
        alphas[t] = log_p[t] + _logsumexp(alphas[t - 1][:, None] + log_a, axis=0)
    betas = np.empty((N, S), _F32)
    betas[N - 1] = 0.0
    for t in range(N - 2, -1, -1):
        betas[t] = _logsumexp(log_a + (log_p[t + 1] + betas[t + 1])[None, :], axis=1)

    log_gamma = alphas + betas
    log_gamma = log_gamma - _logsumexp(log_gamma, axis=1, keepdims=True)
    return np.exp(log_gamma), _logsumexp(alphas[-1], axis=0)


def _vbx_iteration(rho, v, gamma, pi, fa, fb, loop_prob):
    """One VB iteration (BUT VBx: diagonal PLDA + sticky HMM over frames).

    rho [N, D], v [D] (sqrt psi), gamma [N, S], pi [S], all f32.
    """
    fa, fb = _F32(fa), _F32(fb)
    # speaker posterior: precision P_s = 1 + Fa * N_s * psi (diag)
    psi = v**2
    n_s = fa * np.sum(gamma, axis=0)  # [S]
    f_s = fa * (gamma.T @ rho)  # [S, D]
    precision = _F32(1.0) + n_s[:, None] * psi[None, :]  # [S, D]
    inv_l = _F32(1.0) / precision
    mu = inv_l * (f_s * v[None, :])  # posterior mean of z_s [S, D]

    # per-frame log-likelihoods (dropping x'x const shared across speakers)
    #   ln p_ns = x' V mu_s - 0.5 (mu_s^2 + inv_l) psi
    cross = rho @ (mu * v[None, :]).T  # [N, S]
    quad = _F32(0.5) * np.sum((mu**2 + inv_l) * psi[None, :], axis=1)  # [S]
    log_p = fa * (cross - quad[None, :]) / fb

    log_pi = np.log(np.maximum(pi, _F32(1e-10)))
    new_gamma, evidence = _hmm_forward_backward(log_p, log_pi, loop_prob)

    new_pi = np.maximum(np.sum(new_gamma, axis=0), _F32(1e-10))
    new_pi = new_pi / np.sum(new_pi)

    # ELBO: HMM evidence - KL(z posterior || prior)
    kl_z = _F32(0.5) * np.sum(mu**2 + inv_l - np.log(inv_l) - _F32(1.0))
    return new_gamma, new_pi, evidence - kl_z


class VBxClustering:
    def __init__(self, options: VBxOptions | None = None):
        self.options = options or VBxOptions()

    def refine(
        self,
        rho: np.ndarray,
        psi: np.ndarray,
        initial_labels: np.ndarray,
    ) -> VBxResult:
        """Refine AHC warm-start labels with VB EM."""
        opt = self.options
        n = rho.shape[0]
        labels = np.asarray(initial_labels, np.int64)
        n_spk = max(1, int(labels.max()) + 1 if labels.size else 1)

        gamma = np.full((n, n_spk), 0.05 / max(1, n_spk - 1), np.float32)
        gamma[np.arange(n), labels] = 0.95 if n_spk > 1 else 1.0
        gamma /= gamma.sum(axis=1, keepdims=True)
        pi = gamma.sum(axis=0) / n

        rho_j = np.asarray(rho, _F32)
        v = np.sqrt(np.maximum(np.asarray(psi, _F32), _F32(1e-6)))
        gamma_j = gamma
        pi_j = pi.astype(_F32)

        trace: list[float] = []
        for it in range(opt.max_iterations):
            gamma_j, pi_j, elbo = _vbx_iteration(
                rho_j, v, gamma_j, pi_j, opt.fa, opt.fb, opt.loop_probability
            )
            e = float(elbo)
            trace.append(e)
            if len(trace) >= 2 and abs(trace[-1] - trace[-2]) < opt.epsilon * max(1.0, abs(trace[-2])):
                break

        gamma_np = np.asarray(gamma_j)
        pi_np = np.asarray(pi_j)
        # drop empty speakers
        active = pi_np > 1e-3
        if not active.all() and active.any():
            gamma_np = gamma_np[:, active]
            gamma_np /= np.maximum(gamma_np.sum(axis=1, keepdims=True), 1e-10)
            pi_np = pi_np[active] / pi_np[active].sum()
        return VBxResult(
            labels=np.argmax(gamma_np, axis=1),
            gamma=gamma_np,
            pi=pi_np,
            elbo_trace=trace,
        )

    def refine_with_constraints(
        self,
        rho: np.ndarray,
        psi: np.ndarray,
        initial_labels: np.ndarray,
        num_speakers: int = -1,
        min_speakers: int = 1,
        max_speakers: int = 20,
    ) -> VBxResult:
        """VBx + SpeakerCountConstraints (reference VBxClustering.swift:685)."""
        from fluidaudio_tpu_torch.diarizer.offline.types import SpeakerCountConstraints

        result = self.refine(rho, psi, initial_labels)
        labels = result.labels
        k = len(np.unique(labels))
        constraints = SpeakerCountConstraints.resolve(
            num_embeddings=rho.shape[0],
            num_speakers=num_speakers if num_speakers > 0 else None,
            min_speakers=min_speakers,
            max_speakers=max_speakers,
        )
        target = constraints.num_speakers
        min_speakers = constraints.min_speakers
        max_speakers = constraints.max_speakers

        def merge_closest(labels: np.ndarray) -> np.ndarray:
            uniq = np.unique(labels)
            cents = np.stack([rho[labels == u].mean(axis=0) for u in uniq])
            best, pair = np.inf, (0, 1)
            for i in range(len(uniq)):
                for j in range(i + 1, len(uniq)):
                    d = float(np.linalg.norm(cents[i] - cents[j]))
                    if d < best:
                        best, pair = d, (i, j)
            out = labels.copy()
            out[out == uniq[pair[1]]] = uniq[pair[0]]
            # renumber
            _, out = np.unique(out, return_inverse=True)
            return out

        def split_largest(labels: np.ndarray) -> np.ndarray:
            uniq, counts = np.unique(labels, return_counts=True)
            big = uniq[np.argmax(counts)]
            idx = np.where(labels == big)[0]
            if idx.size < 2:
                return labels
            sub = rho[idx]
            center = sub.mean(axis=0)
            d = sub @ (sub[np.argmax(np.linalg.norm(sub - center, axis=1))])
            out = labels.copy()
            new_label = labels.max() + 1
            out[idx[d < np.median(d)]] = new_label
            return out

        limit_low = max(min_speakers, 1) if target is None else target
        limit_high = max_speakers if target is None else target
        guard = 0
        while len(np.unique(labels)) > limit_high and guard < 64:
            labels = merge_closest(labels)
            guard += 1
        while len(np.unique(labels)) < limit_low and guard < 128:
            new = split_largest(labels)
            if len(np.unique(new)) == len(np.unique(labels)):
                break
            labels = new
            guard += 1

        if not np.array_equal(labels, result.labels):
            logger.info("VBx constraints adjusted speakers %d -> %d", k, len(np.unique(labels)))
            # rebuild gamma/pi consistent with the adjusted label ids (the
            # unconstrained posteriors' columns no longer correspond after
            # merges/splits/renumbering): hard one-hot responsibilities +
            # empirical priors over the final labels
            uniq, inverse = np.unique(labels, return_inverse=True)
            gamma = np.zeros((labels.size, uniq.size), np.float64)
            gamma[np.arange(labels.size), inverse] = 1.0
            pi = gamma.mean(axis=0)
            result = VBxResult(labels=inverse, gamma=gamma, pi=pi,
                               elbo_trace=result.elbo_trace,
                               adjusted=True, original_cluster_count=k)
        else:
            result.original_cluster_count = k
        return result
