"""Cache-aware streaming FastConformer of the PyTorch port against JAX.

The port's `StreamingConformerEncoder` runs the JAX encoder's parameters
(every leaf perturbed, so zero-initialised biases, pos_bias_u/v and the
folded BN are exercised too) on the same numpy-seeded mel chunks: one chunk
from empty caches, then three more with the caches carried. The output and
all four cache fields must agree. Then the JAX file's four properties
(`tests/test_streaming_conformer.py`) are repeated on the port alone, and the
Nemotron `_PromptedEncoder` is held against its JAX counterpart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidaudio_tpu.asr import streaming_nemotron as jax_nemotron
from fluidaudio_tpu.models import conformer_streaming as jax_cs
from fluidaudio_tpu_torch.asr import streaming_nemotron as port_nemotron
from fluidaudio_tpu_torch.models import conformer_streaming as port
from fluidaudio_tpu_torch.utils.weights import from_jax_params, load_state

# the size of tests/test_streaming_conformer.py
SMALL = dict(n_mels=16, d_model=32, n_layers=2, n_heads=4, att_context_left=16,
             pre_cache_mel=16, subsampling_channels=16)
# f32: both sides run true f32 and differ only in summation order; the
# largest difference observed over 4 carried chunks is 1.2e-6
F32_TOL = 1e-5
# bf16: each side rounds every matmul and LayerNorm output to bf16 (8
# significant bits, 2^-8 ~ 4e-3 relative) at different points; observed up
# to 0.039 absolute and 0.011 relative L2 on values of order 1. 0.1 absolute
# and 0.02 relative L2 separate that from a layout or index error (O(1))
BF16_ATOL, BF16_REL_L2 = 0.1, 0.02


def _mel(T, seed, n_mels=16):
    return np.random.RandomState(seed).randn(1, n_mels, T).astype(np.float32)


def _perturbed(module, *args):
    params = jax.jit(module.init)(jax.random.PRNGKey(0), *args)
    rs = np.random.RandomState(1)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rs.randn(*x.shape).astype(np.float32), params)


def _fields(caches):
    return {f: np.asarray(getattr(caches, f).float() if torch.is_tensor(getattr(caches, f))
                          else getattr(caches, f), np.float64)
            for f in caches._fields}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    """(JAX apply, JAX params, port encoder, config) at one dtype."""
    cfg_kw = dict(SMALL, dtype=request.param)
    jcfg = jax_cs.StreamingConformerConfig(**cfg_kw)
    jenc = jax_cs.StreamingConformerEncoder(jcfg)
    params = _perturbed(jenc, jnp.zeros((1, 16, 32), jnp.float32), jax_cs.init_caches(jcfg, 1))
    enc = port.StreamingConformerEncoder(port.StreamingConformerConfig(**cfg_kw)).eval()
    load_state(enc, from_jax_params(params))
    return jax.jit(jenc.apply), params, enc, jcfg


def test_carried_chunks_match_jax(pair):
    """One chunk from empty caches, then three carried: the output and
    pre_cache / channel / time / channel_len after every chunk."""
    apply, params, enc, jcfg = pair
    f32 = jcfg.dtype == "float32"
    jc = jax_cs.init_caches(jcfg, 2)
    pc = port.init_caches(enc.cfg, 2, device="cpu")
    for i, T in enumerate((32, 32, 16, 64)):
        mel = np.concatenate([_mel(T, 10 + i), _mel(T, 20 + i)])
        want, jc = apply(params, jnp.asarray(mel), jc)
        got, pc = enc(torch.from_numpy(mel), pc)
        assert got.dtype == torch.float32 and got.shape == want.shape == (2, T // 8, 32)
        assert pc.channel.dtype == enc.cfg.compute_dtype and pc.pre_cache.dtype == torch.float32
        assert pc.channel_len.dtype == torch.int32
        np.testing.assert_array_equal(pc.channel_len.numpy(), np.asarray(jc.channel_len))
        pairs = [("enc", got.numpy(), np.asarray(want, np.float64))]
        pairs += [(f, _fields(pc)[f], _fields(jc)[f]) for f in ("pre_cache", "channel", "time")]
        for name, g, w in pairs:
            if f32:
                np.testing.assert_allclose(g, w, atol=F32_TOL, rtol=F32_TOL,
                                           err_msg=f"chunk {i} {name}")
            else:
                np.testing.assert_allclose(g, w, atol=BF16_ATOL, err_msg=f"chunk {i} {name}")
                rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
                assert rel < BF16_REL_L2, (i, name, rel)


def test_channel_len_saturates_at_context():
    cfg = port.StreamingConformerConfig(**SMALL)
    enc = port.StreamingConformerEncoder(cfg).eval()
    caches = port.init_caches(cfg, 1, device="cpu")
    lens = []
    for i in range(6):
        _, caches = enc(torch.from_numpy(_mel(32, i)), caches)
        lens.append(int(caches.channel_len[0]))
    assert lens == [4, 8, 12, 16, 16, 16]


def test_sinusoid_offsets_ascend_and_match_jax():
    want = np.asarray(jax_cs._sinusoid_offsets(2 * 7 + 16 - 1, 16 + 7 - 1, 32))
    got = port.sinusoid_offsets(2 * 7 + 16 - 1, 16 + 7 - 1, 32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # row r is offset r - (C+T-1), ascending: feature 0 is sin(offset)
    np.testing.assert_allclose(got[:, 0], np.sin(np.arange(29) - 22.0), atol=1e-6)
    assert got[22, 0] == 0.0 and got[22, 1] == 1.0


def test_init_caches_default_device_is_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.init_caches(port.StreamingConformerConfig(**SMALL), 1)


# ----------------------------------------- the JAX file's properties, on the port


@pytest.fixture(scope="module")
def encoder():
    cfg = port.StreamingConformerConfig(**SMALL)
    enc = port.StreamingConformerEncoder(cfg).eval()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in enc.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return enc


def _run(enc, mel, width):
    caches = port.init_caches(enc.cfg, 1, device="cpu")
    outs = []
    for i in range(mel.shape[2] // width):
        out, caches = enc(torch.from_numpy(mel[:, :, i * width:(i + 1) * width]), caches)
        outs.append(out)
    return torch.cat(outs, dim=1).numpy()


@pytest.mark.parametrize("width", [32, 16], ids=["two_chunks", "four_chunks"])
def test_chunked_equals_full(encoder, width):
    """Carried caches make chunks equal one full-length chunk (tolerance of
    the JAX test, 2e-2: f32 reassociation compounding through LayerNorms)."""
    mel = _mel(64, 0 if width == 32 else 1)
    full = _run(encoder, mel, 64)
    chunked = _run(encoder, mel, width)
    assert full.shape == chunked.shape == (1, 8, 32)
    np.testing.assert_allclose(chunked, full, rtol=2e-2, atol=2e-2)


def test_causality_exact(encoder):
    """Perturbing future input changes no earlier output frame at all."""
    a = _mel(64, 7)
    b = a.copy()
    b[:, :, 32:] += 10.0
    oa, ob = _run(encoder, a, 64), _run(encoder, b, 64)
    np.testing.assert_array_equal(oa[:, :4], ob[:, :4])
    assert np.abs(oa[:, 4:] - ob[:, 4:]).max() > 1e-3


def test_bounded_context_forgets(encoder):
    """Long, very different prefixes: the last chunk stays finite and of the
    same shape (the bounded caches cannot blow up)."""
    rng = np.random.RandomState(2)
    tail = rng.randn(1, 16, 32).astype(np.float32)
    outs = [_run(encoder, np.concatenate([p, tail], axis=2), 32)[:, -4:]
            for p in (rng.randn(1, 16, 320).astype(np.float32),
                      rng.randn(1, 16, 320).astype(np.float32) * 3.0)]
    assert outs[0].shape == outs[1].shape == (1, 4, 32)
    assert all(np.isfinite(o).all() for o in outs)


# ------------------------------------------------------------- prompted encoder


def test_prompted_encoder_matches_jax():
    """`_PromptedEncoder` adds prompt_embed[prompt_id] per row after the f32
    cast: two rows with different prompts, two carried chunks."""
    jcfg = jax_cs.StreamingConformerConfig(**SMALL)
    jenc = jax_nemotron._PromptedEncoder(jcfg, 4)
    params = _perturbed(jenc, jnp.zeros((1, 16, 32), jnp.float32),
                        jax_cs.init_caches(jcfg, 1), jnp.zeros((1,), jnp.int32))
    enc = port_nemotron._PromptedEncoder(port.StreamingConformerConfig(**SMALL), 4).eval()
    load_state(enc, from_jax_params(params))
    assert set(enc.state_dict()) >= {"prompt_embed", "encoder.block1.final_ln.weight"}
    prompts = np.array([1, 3], np.int32)
    jc, pc = jax_cs.init_caches(jcfg, 2), port.init_caches(enc.encoder.cfg, 2, device="cpu")
    for i in range(2):
        mel = np.concatenate([_mel(32, 30 + i), _mel(32, 40 + i)])
        want, jc = jenc.apply(params, jnp.asarray(mel), jc, jnp.asarray(prompts))
        got, pc = enc(torch.from_numpy(mel), pc, torch.from_numpy(prompts))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
    # no table without prompts (the English model)
    bare = port_nemotron._PromptedEncoder(enc.encoder.cfg, 0)
    assert "prompt_embed" not in bare.state_dict()
