"""`ops/self_attention.py` on the CPU: the plain version against the head's
former attention code, the kernel's tiled arithmetic emulated in torch, the
masks' semantics, the wrapper's checks (on meta tensors, which reach every
check but the launch) and the Sortformer head's routing and span count.
The kernel itself is compared with the plain version on the card
(`tests/test_torch_cuda.py`)."""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fluidaudio_tpu_torch.models import sortformer as sf
from fluidaudio_tpu_torch.ops import self_attention as sa
from fluidaudio_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]


def _qkv(B, N, H, Dh, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, N, H, Dh, generator=g).to(dtype) for _ in range(3)]


def _mask(B, N, seed, share=0.6):
    return torch.from_numpy(np.random.RandomState(seed).rand(B, N) < share)


def _before(q, k, v, mask):
    """The head's attention as `_NemoTfBlock.forward` computed it before the
    op, with its [B, 1, N, N] mask."""
    hd = q.shape[-1]
    scores = torch.einsum("bnhd,bmhd->bhnm", q, k).float() / np.float32(math.sqrt(hd))
    scores = torch.where(mask, scores, torch.finfo(q.dtype).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v)


def _emulate_kernel(q, k, v, valid, tile):
    """The kernel's arithmetic: q prescaled by log2(e) / sqrt(Dh) (zero for a
    masked query), key tiles of `tile` with an additive 0 / -inf bias (key
    validity for a valid query, nothing for a masked one), an online
    softmax in base 2 whose running max guards tiles with no valid key, and
    one division by the row sum at the end."""
    B, N, H, Dh = q.shape
    qv = torch.ones(B, N, dtype=torch.bool) if valid is None else valid
    qs = torch.where(qv[:, :, None, None], q * (math.log2(math.e) / math.sqrt(Dh)), 0.0)
    key_bias = torch.where(qv, 0.0, -math.inf)
    m = torch.full((B, N, H), -math.inf)
    ell = torch.zeros(B, N, H)
    o = torch.zeros(B, N, H, Dh)
    for m0 in range(0, N, tile):
        s = torch.einsum("bnhd,bmhd->bnhm", qs, k[:, m0:m0 + tile])
        s = s + torch.where(qv[:, :, None, None], key_bias[:, None, None, m0:m0 + tile], 0.0)
        mx = torch.maximum(m, s.amax(-1))
        m_use = torch.where(mx == -math.inf, 0.0, mx)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use[..., None])
        ell = ell * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("bnhm,bmhd->bnhd", p, v[:, m0:m0 + tile])
        m = mx
    return o / ell[..., None]


@pytest.mark.parametrize("B,N,H,Dh", [(2, 40, 8, 24), (3, 17, 4, 8), (1, 64, 2, 40),
                                      (2, 9, 3, 12)])
def test_plain_without_a_mask_equals_the_former_code_with_an_all_true_one(B, N, H, Dh):
    q, k, v = _qkv(B, N, H, Dh, seed=N)
    want = _before(q, k, v, torch.ones(B, 1, N, N, dtype=torch.bool))
    assert torch.equal(sa.self_attention_plain(q, k, v), want)
    assert torch.equal(sa.self_attention_plain(q, k, v, torch.ones(B, N, dtype=torch.bool)),
                       want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_with_a_mask_equals_the_former_code(seed):
    B, N, H, Dh = 2, 30, 4, 8
    q, k, v = _qkv(B, N, H, Dh, seed=seed)
    valid = _mask(B, N, seed)
    mask = valid[:, None, None, :] & valid[:, None, :, None]
    assert torch.equal(sa.self_attention_plain(q, k, v, valid), _before(q, k, v, mask))


@pytest.mark.parametrize("masked", [[0], [5, 6], list(range(12))])
def test_a_fully_masked_query_takes_the_mean_of_v(masked):
    B, N, H, Dh = 2, 12, 4, 8
    q, k, v = _qkv(B, N, H, Dh, seed=3)
    valid = torch.ones(B, N, dtype=torch.bool)
    valid[1, masked] = False
    got = sa.self_attention_plain(q, k, v, valid)
    assert torch.isfinite(got).all()
    mean = v[1].mean(0)
    for n in masked:
        torch.testing.assert_close(got[1, n], mean, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("seed", [4, 5])
def test_masked_keys_get_zero_weight(seed):
    B, N, H, Dh = 2, 20, 4, 8
    q, k, v = _qkv(B, N, H, Dh, seed=seed)
    valid = _mask(B, N, seed)
    valid[:, 0] = True
    got = sa.self_attention_plain(q, k, v, valid)
    k2, v2 = k.clone(), v.clone()
    k2[~valid], v2[~valid] = 100.0, -50.0
    again = sa.self_attention_plain(q, k2, v2, valid)
    torch.testing.assert_close(again[valid], got[valid], atol=1e-7, rtol=0)


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("case", ["none", "random", "last_tile_only", "all_masked_row"])
def test_the_kernels_tiled_arithmetic_matches_plain(tile, case):
    """Within 1e-5, the tolerance of the card's comparison: rows whose first
    tiles hold no valid key, and a batch row with every position masked."""
    B, N, H, Dh = 2, 75, 4, 24
    q, k, v = _qkv(B, N, H, Dh, seed=tile)
    valid = None
    if case == "random":
        valid = _mask(B, N, tile, share=0.3)
    elif case == "last_tile_only":
        valid = torch.zeros(B, N, dtype=torch.bool)
        valid[:, N - 3:] = True
        valid[0, :2] = True
    elif case == "all_masked_row":
        valid = _mask(B, N, tile)
        valid[1] = False
    want = sa.self_attention_plain(q, k, v, valid)
    torch.testing.assert_close(_emulate_kernel(q, k, v, valid, tile), want, atol=1e-5, rtol=0)


def _meta(B=2, N=8, H=4, Dh=24, dtype=torch.float32):
    return torch.empty(B, N, H, Dh, dtype=dtype, device="meta")


def _bad_inputs(bad):
    q = k = v = _meta()
    valid = None
    if bad == "float64":
        q = k = v = _meta(dtype=torch.float64)
    elif bad == "bfloat16_v":
        v = _meta(dtype=torch.bfloat16)
    elif bad == "q_3d":
        q = torch.empty(2, 8, 96, device="meta")
    elif bad == "k_shape":
        k = _meta(N=9)
    elif bad in ("dh4", "dh12", "dh72"):
        q = k = v = _meta(H=2, Dh=int(bad[2:]))
    elif bad == "last_axis_strided":
        q = _meta().transpose(-1, -2).contiguous().transpose(-1, -2)
    elif bad == "strides_not_16_bytes":  # rows of 98 floats: a Linear of width 96 padded by 2
        q = torch.empty(2, 8, 98, device="meta")[..., :96].reshape(2, 8, 4, 24)
    elif bad == "valid_shape":
        valid = torch.ones(2, 9, dtype=torch.bool, device="meta")
    elif bad == "valid_dtype":
        valid = torch.ones(2, 8, dtype=torch.uint8, device="meta")
    elif bad == "valid_device":
        valid = torch.ones(2, 8, dtype=torch.bool)
    elif bad == "meta_device":  # everything else right: only the device is wrong
        pass
    return q, k, v, valid


@pytest.mark.parametrize("bad", ["float64", "bfloat16_v", "q_3d", "k_shape", "dh4", "dh12",
                                 "dh72", "last_axis_strided", "strides_not_16_bytes",
                                 "valid_shape", "valid_dtype", "valid_device", "meta_device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    before = sa.self_attention.launches
    with pytest.raises(ValueError):
        sa.self_attention(*_bad_inputs(bad))
    assert sa.self_attention.launches == before


@pytest.mark.parametrize("dh,takes", [(8, True), (24, True), (40, True), (64, True), (4, False),
                                      (12, False), (72, False), (0, False)])
def test_kernel_takes_head_dim(dh, takes):
    assert sa.kernel_takes_head_dim(dh) is takes


@pytest.mark.parametrize("with_mask", [False, True])
def test_cpu_tensors_take_the_plain_version_without_a_launch(with_mask):
    q, k, v = _qkv(2, 16, 4, 8, seed=6)
    valid = _mask(2, 16, 6) if with_mask else None
    launches, calls = sa.self_attention.launches, sa.self_attention_plain.calls
    got = sa.self_attention(q, k, v, valid)
    assert sa.self_attention.launches == launches
    assert sa.self_attention_plain.calls == calls + 1
    assert torch.equal(got, sa.self_attention_plain(q, k, v, valid))


def test_the_module_imports_and_runs_without_cuda():
    """No build and no CUDA call at import or on a CPU tensor."""
    code = ("import torch\n"
            "from fluidaudio_tpu_torch.ops import self_attention as sa\n"
            "q = torch.randn(1, 8, 2, 8)\n"
            "sa.self_attention(q, q, q)\n"
            "assert sa.load_library.cache_info().currsize == 0\n"
            "assert sa.self_attention.launches == 0 and sa.self_attention_plain.calls == 1\n"
            "assert not torch.cuda.is_initialized()\n")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=300)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return sf.SortformerModel(sf.SORTFORMER_TEST, device="cpu").eval()


def test_predict_without_a_mask_equals_an_all_true_mask(model):
    ctx = torch.randn(2, 20, sf.SORTFORMER_TEST.d_model)
    assert torch.equal(model.predict(ctx), model.predict(ctx, torch.ones(2, 20, dtype=torch.bool)))


@pytest.mark.parametrize("d,heads,dtype,route", [
    (32, 4, torch.float32, "kernel"),  # the trained fixture's Dh 8
    (192, 8, torch.float32, "kernel"),  # SORTFORMER_V2: Dh 24
    (48, 4, torch.float32, "plain"),  # Dh 12: the kernel does not take it
    (32, 4, torch.bfloat16, "plain"),  # the kernel is f32 only
])
def test_block_routes_by_dtype_and_head_width(monkeypatch, d, heads, dtype, route):
    seen = []
    monkeypatch.setattr(sf, "self_attention",
                        lambda *a: seen.append("kernel") or sa.self_attention_plain(*a))
    monkeypatch.setattr(sf, "self_attention_plain",
                        lambda *a: seen.append("plain") or sa.self_attention_plain(*a))
    block = sf._NemoTfBlock(d, heads, device="cpu").to(dtype)
    out = block(torch.randn(2, 6, d).to(dtype), None)
    assert seen == [route] and out.shape == (2, 6, d) and out.dtype == dtype


def test_the_head_span_counts_the_layers_that_launched(model):
    """0 on the CPU (the plain version); the card test reads 18 at V2."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        model(torch.randn(2, sf.SORTFORMER_TEST.n_mels, 64))
    s = profiling.summary()
    profiling.reset()
    assert s["sortformer.head"]["count"] == 1
    assert s["sortformer.head"]["counts"] == {"attn_kernel_layers": 0}
