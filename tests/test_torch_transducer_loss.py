"""The port's RNN-T and TDT losses (`train/transducer_loss.py`) against JAX.

JAX's six brute-force cases (`tests/test_transducer_loss.py`: path
enumeration on small lattices, its `brute_rnnt` / `brute_tdt`) run on the
port's losses at JAX's tolerances (rtol 1e-5 for RNN-T, 1e-4 for TDT). Then
losses and gradients against `jax.grad` of JAX's losses on the same seeded
lattices, with mixed lengths, `durations` with and without 0, and 0 not
first: losses within 1e-5 relative, gradients within 1e-5 relative L2 (the
two libraries' logcumsumexp and associative scan round apart, observed
below 1e-6).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidaudio_tpu.train import transducer_loss as jax_loss
from fluidaudio_tpu_torch.train import rnnt_loss, tdt_loss
from fluidaudio_tpu_torch.train import transducer_loss as port_loss
from tests.test_torch_custom_vocab import jax_module, one_torch_thread  # noqa: F401

ref = jax_module("test_transducer_loss.py", modules=())  # JAX's brute-force references


def _log_softmax(x: np.ndarray) -> np.ndarray:
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# --------------------------------------------------- JAX's brute-force cases


def test_rnnt_matches_brute_force():
    rng = np.random.RandomState(0)
    T, U, V, blank = 4, 3, 5, 4
    log_probs = _log_softmax(rng.randn(1, T, U + 1, V).astype(np.float32))
    labels = rng.randint(0, blank, (1, U)).astype(np.int32)
    loss = rnnt_loss(_t(log_probs), _t(labels), torch.tensor([T]), torch.tensor([U]), blank)
    want = ref.brute_rnnt(log_probs[0], labels[0], T, U, blank)
    np.testing.assert_allclose(float(loss[0]), want, rtol=1e-5)


def test_rnnt_batch_with_mixed_lengths():
    rng = np.random.RandomState(1)
    T, U, V, blank = 5, 3, 6, 5
    log_probs = _log_softmax(rng.randn(3, T, U + 1, V).astype(np.float32))
    labels = rng.randint(0, blank, (3, U)).astype(np.int32)
    t_len, u_len = np.array([5, 4, 3]), np.array([3, 2, 0])
    loss = rnnt_loss(_t(log_probs), _t(labels), _t(t_len), _t(u_len), blank)
    for b in range(3):
        want = ref.brute_rnnt(log_probs[b, :t_len[b]], labels[b], t_len[b], u_len[b], blank)
        np.testing.assert_allclose(float(loss[b]), want, rtol=1e-5, err_msg=f"row {b}")


def test_rnnt_gradients_finite():
    rng = np.random.RandomState(2)
    T, U, V, blank = 4, 2, 5, 4
    logits = torch.tensor(rng.randn(2, T, U + 1, V), dtype=torch.float32, requires_grad=True)
    labels = torch.from_numpy(rng.randint(0, blank, (2, U)).astype(np.int32))
    rnnt_loss(torch.log_softmax(logits, -1), labels, torch.tensor([T, T]),
              torch.tensor([U, U]), blank).sum().backward()
    g = logits.grad.numpy()
    assert np.all(np.isfinite(g))
    # the gradient wrt the log-softmax inputs sums to ~0 per (t, u) slice
    np.testing.assert_allclose(g.sum(axis=-1), 0.0, atol=1e-4)


@pytest.mark.parametrize("durations", [(0, 1, 2), (1, 2)], ids=["with_zero", "no_zero"])
def test_tdt_matches_brute_force(durations):
    rng = np.random.RandomState(3)
    T, U, V, blank = (4, 2, 4, 3) if 0 in durations else (5, 2, 4, 3)
    tok = _log_softmax(rng.randn(1, T, U + 1, V).astype(np.float32))
    dur = _log_softmax(rng.randn(1, T, U + 1, len(durations)).astype(np.float32))
    labels = rng.randint(0, blank, (1, U)).astype(np.int32)
    loss = tdt_loss(_t(tok), _t(dur), durations, _t(labels), torch.tensor([T]),
                    torch.tensor([U]), blank)
    want = ref.brute_tdt(tok[0], dur[0], durations, labels[0], T, U, blank)
    np.testing.assert_allclose(float(loss[0]), want, rtol=1e-4)


def test_tdt_gradients_finite():
    rng = np.random.RandomState(4)
    T, U, V, blank = 4, 2, 4, 3
    tl = torch.tensor(rng.randn(2, T, U + 1, V), dtype=torch.float32, requires_grad=True)
    dl = torch.tensor(rng.randn(2, T, U + 1, 3), dtype=torch.float32, requires_grad=True)
    labels = torch.from_numpy(rng.randint(0, blank, (2, U)).astype(np.int32))
    tdt_loss(torch.log_softmax(tl, -1), torch.log_softmax(dl, -1), (0, 1, 2), labels,
             torch.tensor([T, T]), torch.tensor([U, U]), blank).sum().backward()
    assert np.all(np.isfinite(tl.grad.numpy()))
    assert np.all(np.isfinite(dl.grad.numpy()))


# ------------------------------------------------ against jax.grad of JAX's


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


LATTICE = dict(B=4, T=9, U=5, V=7)
T_LEN = np.array([9, 7, 4, 9], np.int32)
U_LEN = np.array([5, 3, 0, 4], np.int32)  # row 2 has no labels


@pytest.mark.parametrize("seed", [0, 1])
def test_rnnt_loss_and_grad_equal_jax(seed):
    rng = np.random.RandomState(10 + seed)
    B, T, U, V = LATTICE.values()
    blank = V - 1
    logits = rng.randn(B, T, U + 1, V).astype(np.float32)
    labels = rng.randint(0, blank, (B, U)).astype(np.int32)

    def f(lg):
        lp = jax.nn.log_softmax(lg, axis=-1)
        return jnp.sum(jax_loss.rnnt_loss(lp, jnp.asarray(labels), jnp.asarray(T_LEN),
                                          jnp.asarray(U_LEN), blank))

    want_loss, want_grad = jax.value_and_grad(f)(jnp.asarray(logits))
    lg = torch.tensor(logits, requires_grad=True)
    loss = rnnt_loss(torch.log_softmax(lg, -1), _t(labels), _t(T_LEN), _t(U_LEN), blank).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert _rel(lg.grad.numpy(), np.asarray(want_grad)) <= 1e-5


@pytest.mark.parametrize("durations", [(0, 1, 2, 3, 4), (1, 2, 3), (2, 0, 1), (1, 0, 3)],
                         ids=["tdt", "no_zero", "zero_second", "zero_gap"])
def test_tdt_loss_and_grad_equal_jax(durations):
    rng = np.random.RandomState(sum(durations) + len(durations))
    B, T, U, V = LATTICE.values()
    blank = V - 1
    tl = rng.randn(B, T, U + 1, V).astype(np.float32)
    dl = rng.randn(B, T, U + 1, len(durations)).astype(np.float32)
    labels = rng.randint(0, blank, (B, U)).astype(np.int32)

    def f(a, b):
        return jnp.sum(jax_loss.tdt_loss(
            jax.nn.log_softmax(a, axis=-1), jax.nn.log_softmax(b, axis=-1), durations,
            jnp.asarray(labels), jnp.asarray(T_LEN), jnp.asarray(U_LEN), blank))

    want_loss, (want_gt, want_gd) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(tl), jnp.asarray(dl))
    a = torch.tensor(tl, requires_grad=True)
    b = torch.tensor(dl, requires_grad=True)
    loss = tdt_loss(torch.log_softmax(a, -1), torch.log_softmax(b, -1), durations, _t(labels),
                    _t(T_LEN), _t(U_LEN), blank).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert _rel(a.grad.numpy(), np.asarray(want_gt)) <= 1e-5
    assert _rel(b.grad.numpy(), np.asarray(want_gd)) <= 1e-5


def test_log_cum_prefix_equals_jax():
    """The intra-frame recurrence on NEG-masked rows (the cells past a row's
    label count): equal where JAX's is finite and meaningful, and the
    gradient of a valid cell reaches no masked cell."""
    rng = np.random.RandomState(5)
    base = rng.randn(3, 6).astype(np.float32)
    emit = rng.randn(3, 6).astype(np.float32)
    emit[:, 4:] = port_loss.NEG
    want = np.asarray(jax_loss._log_cum_prefix(jnp.asarray(base), jnp.asarray(emit)))
    b = torch.tensor(base, requires_grad=True)
    got = port_loss._log_cum_prefix(b, torch.from_numpy(emit))
    np.testing.assert_allclose(got[:, :5].detach().numpy(), want[:, :5], rtol=1e-6, atol=1e-6)
    got[:, 4].sum().backward()
    assert np.all(np.isfinite(b.grad.numpy())) and not b.grad[:, 5].any()


def test_train_package_exports_jax_names():
    import fluidaudio_tpu.train as jax_train
    import fluidaudio_tpu_torch.train as port_train

    assert port_train.__all__ == jax_train.__all__ == ["rnnt_loss", "tdt_loss"]
