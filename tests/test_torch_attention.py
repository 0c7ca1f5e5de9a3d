"""Rel-pos attention of the PyTorch port against the JAX package.

`relpos_attention_plain` (the CPU path and the kernel's on-card oracle) is
held against `relpos_attention_reference` and against the Pallas kernel in
interpret mode, with the peaked probes and the shift-only probe of
`tests/test_attention_pallas.py`, also on the strided views and the `out=`
buffer the encoder passes. Padded query rows are undefined in every
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


def test_kernel_source_multiplies_tma_tiles_with_wgmma():
    """The bf16 path issues `wgmma` on tiles that TMA brought in, and the
    `mma.sync` path it replaced is gone (the build itself runs on the card)."""
    src = port.KERNEL_SOURCE.read_text()
    assert "cp.async.bulk.tensor" in src and "mbarrier.try_wait" in src
    assert "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16" in src
    assert "mma.sync" not in src


def _strided(x: np.ndarray, axes) -> torch.Tensor:
    """A torch view of x with its axes permuted back from a copy laid out in
    `axes` order, so the view has x's shape and non-contiguous strides."""
    inverse = np.argsort(axes)
    return torch.from_numpy(np.ascontiguousarray(x.transpose(axes))).permute(*inverse)


@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.bfloat16])
def test_plain_on_strided_views_and_out_matches_reference(out_dtype):
    """The encoder's call: [B, T, H, Dh] projections seen as [B, H, T, Dh]
    views, p as the [H, 2T-1, Dh] view of a [2T-1, H, Dh] tensor, and the
    result written into the [B, H, T, Dh] view of a [B, T, H, Dh] buffer.
    f32 to the 1e-4 of the contiguous case; bf16 out is the f32 result
    rounded once (bit for bit), so within the 3e-2 the bf16 cases use."""
    B, H, T, Dh = 2, 2, 40, 64
    lengths = [40, 17]
    qu, qw, k, v, p = _mk(B, H, T, Dh, seed=7)
    views = [_strided(x, (0, 2, 1, 3)) for x in (qu, qw, k, v)]
    pv = _strided(p, (1, 0, 2))
    assert not any(x.is_contiguous() for x in views + [pv])
    lens = torch.tensor(lengths, dtype=torch.int32)
    want = np.asarray(relpos_attention_reference(
        *(jnp.asarray(x) for x in (qu, qw, k, v, p)), jnp.asarray(lengths, jnp.int32), T))
    f32 = port.relpos_attention(*views, pv, lens, T)
    _valid_rows_close(f32.numpy(), want, lengths, atol=1e-4, rtol=1e-4)
    if out_dtype is None:
        return
    buf = torch.full((B, T, H, Dh), float("nan"), dtype=out_dtype)
    got = port.relpos_attention(*views, pv, lens, T, out=buf.transpose(1, 2))
    assert got.data_ptr() == buf.data_ptr() and got.shape == (B, H, T, Dh)
    torch.testing.assert_close(got, f32.to(out_dtype), rtol=0, atol=0)
    tol = 1e-4 if out_dtype == torch.float32 else 3e-2
    _valid_rows_close(got.float().numpy(), want, lengths, atol=tol, rtol=tol)


@pytest.mark.parametrize("shape,strides,want", [
    ((2, 3, 5, 16), (240, 80, 16, 1), [240, 80, 16]),  # contiguous f32
    ((2, 3, 5, 16), (240, 16, 48, 1), [240, 16, 48]),  # [B, T, H, Dh] transposed
    ((1, 1, 5, 16), (7, 3, 16, 1), [80, 80, 16]),  # size-1 axes: contiguous strides
])
def test_kernel_strides_of_a_view(shape, strides, want):
    """What the wrapper hands the kernel: element strides of every axis but
    the last; an axis of size 1 is never stepped along and gets the stride a
    contiguous tensor would have."""
    x = torch.zeros(4096).as_strided(shape, strides)
    assert port._strides("x", x) == want


@pytest.mark.parametrize("bad", ["inner_stride", "stride_not_16_bytes", "misaligned_start"])
def test_kernel_strides_reject_what_tma_cannot_read(bad):
    base = torch.zeros(8192, dtype=torch.bfloat16)
    if bad == "inner_stride":
        x = base.as_strided((2, 2, 4, 16), (256, 128, 32, 2))
    elif bad == "stride_not_16_bytes":
        x = base.as_strided((2, 2, 4, 16), (260, 130, 20, 1))  # 40-byte rows
    else:
        x = base[1:].as_strided((2, 2, 4, 16), (128, 64, 16, 1))
    with pytest.raises(ValueError):
        port._strides("x", x)


@pytest.mark.parametrize("bad", ["t_real", "qw_shape", "p_shape", "lengths_shape", "device",
                                 "out_shape", "out_device"])
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
    out = None
    if bad == "out_shape":
        out = torch.zeros(B, T, H, Dh)
    elif bad == "out_device":
        out = torch.zeros(B, H, T, Dh, device="meta")
    with pytest.raises(ValueError):
        port.relpos_attention(*t, p, lengths, t_real, out=out)
