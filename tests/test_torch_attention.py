"""Rel-pos attention of the PyTorch port against the JAX package.

`relpos_attention_plain` (the CPU path and the kernel's on-card oracle) is
held against `relpos_attention_reference` and against the Pallas kernel in
interpret mode, with the peaked probes and the shift-only probe of
`tests/test_attention_pallas.py`. Padded query rows are undefined in every
path, so only valid rows are compared. The CUDA kernel itself is tested on
the card by `tests/test_torch_cuda.py`.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fluidaudio_tpu.ops.attention_pallas import (
    relpos_attention as jax_relpos_attention,
    relpos_attention_reference,
)
from fluidaudio_tpu_torch.ops import attention as port


def _mk(B=2, H=2, T=40, Dh=128, seed=0):
    # unit-scale inputs make the softmax PEAKED, so an index-map error in the
    # XL shift shows up instead of averaging away under near-uniform probs
    rng = np.random.RandomState(seed)
    f = lambda: rng.randn(B, H, T, Dh).astype(np.float32)
    qu, qw, k, v = f(), f(), f(), f()
    p = rng.randn(H, 2 * T - 1, Dh).astype(np.float32)
    return qu, qw, k, v, p


def _bf16(x: np.ndarray) -> np.ndarray:
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _port(qu, qw, k, v, p, lengths, T):
    t = [torch.from_numpy(x) for x in (qu, qw, k, v, p)]
    out = port.relpos_attention(*t, torch.tensor(lengths, dtype=torch.int32), T)
    return out.numpy()


def _valid_rows_close(got, want, lengths, atol, rtol):
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :, :n], want[b, :, :n], atol=atol, rtol=rtol)


@pytest.mark.parametrize("lengths,Dh,seed", [
    ([40, 40], 128, 0),
    ([40, 17], 128, 1),
    ([40, 1], 64, 3),
    ([33, 40], 16, 4),
])
def test_plain_matches_jax_reference(lengths, Dh, seed):
    """f32 in, f32 math on both sides: agreement to f32 rounding (1e-4)."""
    T = 40
    qu, qw, k, v, p = _mk(2, 2, T, Dh, seed)
    want = np.asarray(relpos_attention_reference(
        *(jnp.asarray(x) for x in (qu, qw, k, v, p)),
        jnp.asarray(lengths, jnp.int32), T))
    got = _port(qu, qw, k, v, p, lengths, T)
    assert got.dtype == np.float32 and got.shape == (2, 2, T, Dh)
    _valid_rows_close(got, want, lengths, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("lengths,seed", [([40, 40], 0), ([40, 17], 1)])
def test_plain_matches_pallas_interpret(lengths, seed):
    """The Pallas kernel casts its inputs to bf16; given the same
    bf16-rounded inputs the port agrees within its f32-softmax / bf16-probs
    rounding (3e-2, the tolerance `test_attention_pallas.py` uses)."""
    T = 40
    qu, qw, k, v, p = _mk(2, 2, T, 128, seed)
    lens = jnp.asarray(lengths, jnp.int32)
    want = np.asarray(jax_relpos_attention(
        *(jnp.asarray(x) for x in (qu, qw, k, v, p)), lens, T, interpret=True))
    got = _port(*(_bf16(x) for x in (qu, qw, k, v, p)), lengths, T)
    _valid_rows_close(got, want, lengths, atol=3e-2, rtol=3e-2)


def test_shift_only_probe_matches_pallas_interpret():
    """q.k = 0 leaves only the shifted position term: a wrong XL index puts
    the sharp peak on the wrong key, which v's per-key signature exposes."""
    B, H, T, Dh = 1, 1, 24, 128
    rng = np.random.RandomState(2)
    qw = rng.randn(B, H, T, Dh).astype(np.float32) * 2.0
    p = rng.randn(H, 2 * T - 1, Dh).astype(np.float32) * 2.0
    v = rng.randn(B, H, T, Dh).astype(np.float32)
    zeros = np.zeros((B, H, T, Dh), np.float32)
    want = np.asarray(jax_relpos_attention(
        *(jnp.asarray(x) for x in (zeros, qw, zeros, v, p)),
        jnp.asarray([T], jnp.int32), T, interpret=True))
    got = _port(zeros, _bf16(qw), zeros, _bf16(v), _bf16(p), [T], T)
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
    # the f32 plain version against the explicit NeMo index map, exactly
    bd = np.einsum("bhtd,hrd->bhtr", qw, p)
    r = np.arange(T)[None, :] - np.arange(T)[:, None] + (T - 1)
    bd = np.take_along_axis(bd, np.broadcast_to(r, (B, H, T, T)), axis=-1)
    probs = np.exp(bd / np.sqrt(Dh) - (bd / np.sqrt(Dh)).max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    np.testing.assert_allclose(_port(zeros, qw, zeros, v, p, [T], T),
                               np.einsum("bhts,bhsd->bhtd", probs, v),
                               atol=1e-4, rtol=1e-4)


def test_masked_columns_get_f32_min_not_inf():
    """A row with length 0 masks every key with f32 min, so it averages v
    uniformly (as the reference does) instead of producing NaN."""
    qu, qw, k, v, p = _mk(1, 2, 8, 16, 5)
    got = _port(qu, qw, k, v, p, [0], 8)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(1, keepdims=True), got[0].shape),
                               atol=1e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_path_without_launching():
    qu, qw, k, v, p = _mk(2, 2, 12, 32, 6)
    before = port.relpos_attention.launches
    got = _port(qu, qw, k, v, p, [12, 5], 12)
    want = port.relpos_attention_plain(
        *(torch.from_numpy(x) for x in (qu, qw, k, v, p)),
        torch.tensor([12, 5], dtype=torch.int32), 12).numpy()
    np.testing.assert_array_equal(got, want)
    assert port.relpos_attention.launches == before


def test_kernel_module_imports_without_cuda():
    """Importing the wrapper neither builds nor loads the CUDA library."""
    assert port.load_library.cache_info().currsize == 0
    assert port.KERNEL_SOURCE.exists()
    assert "relpos_attention_launch" in port.KERNEL_SOURCE.read_text()


@pytest.mark.parametrize("bad", ["t_real", "qw_shape", "p_shape", "lengths_shape", "device"])
def test_wrapper_rejects_bad_arguments(bad):
    B, H, T, Dh = 2, 2, 8, 16
    t = [torch.zeros(B, H, T, Dh) for _ in range(4)]
    p = torch.zeros(H, 2 * T - 1, Dh)
    lengths = torch.full((B,), T, dtype=torch.int32)
    t_real = T
    if bad == "t_real":
        t_real = T - 1
    elif bad == "qw_shape":
        t[1] = torch.zeros(B, H, T, Dh + 16)
    elif bad == "p_shape":
        p = torch.zeros(H, 2 * T, Dh)
    elif bad == "lengths_shape":
        lengths = torch.full((B + 1,), T, dtype=torch.int32)
    elif bad == "device":
        t = [x.to("meta") for x in t]
        p, lengths = p.to("meta"), lengths.to("meta")
    with pytest.raises(ValueError):
        port.relpos_attention(*t, p, lengths, t_real)
