"""FastConformer encoder of the PyTorch port against the JAX encoder.

Both encoders run the same parameters (the JAX tree handed over through
`utils.weights.from_jax_params`) on the same numpy-seeded mel batch with
ragged lengths, in float32. On the CPU the JAX encoder takes its einsum
attention path and the port its plain attention; the two agree on valid rows
and both zero the padded rows. Configurations: the trained `test-tiny` npz
(Dh 16) and a small Dh=128 encoder, the head width of v3's kernel branch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import unflatten_dict

from fluidaudio_tpu.models import conformer as jax_conformer
from fluidaudio_tpu.train.fixtures import trained_assets_dir
from fluidaudio_tpu_torch.models import conformer as port
from fluidaudio_tpu_torch.ops.attention import relpos_attention
from fluidaudio_tpu_torch.utils.weights import from_jax_params, load_state
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

TINY = dict(d_model=64, n_layers=2, n_heads=4, subsampling_channels=32, dtype="float32")
DH128 = dict(d_model=256, n_layers=2, n_heads=2, subsampling_channels=32, dtype="float32")


def _trained_tiny_params():
    with np.load(trained_assets_dir() / "asr" / "encoder.npz") as data:
        return unflatten_dict({tuple(k.split("/")): data[k] for k in data.files})


def _perturbed_init(cfg_kwargs, mel, lengths):
    """JAX init with every leaf perturbed, so zero-initialised biases,
    pos_bias_u/v and the folded BN are exercised too."""
    enc = jax_conformer.ConformerEncoder(jax_conformer.ConformerConfig(**cfg_kwargs))
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(lengths))
    rs = np.random.RandomState(1)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rs.randn(*x.shape).astype(np.float32), params)


def _mel(B, T, seed):
    return np.random.RandomState(seed).randn(B, 128, T).astype(np.float32)


def _both(cfg_kwargs, params, mel, lengths):
    want, want_len = jax_conformer.ConformerEncoder(
        jax_conformer.ConformerConfig(**cfg_kwargs)
    ).apply(params, jnp.asarray(mel), jnp.asarray(lengths))
    enc = port.ConformerEncoder(port.ConformerConfig(**cfg_kwargs)).eval()
    load_state(enc, from_jax_params(params))
    got, got_len = enc(torch.from_numpy(mel), torch.from_numpy(lengths))
    return np.asarray(want), np.asarray(want_len), got.numpy(), got_len.numpy()


@pytest.mark.parametrize("name", ["trained_tiny", "dh128"])
def test_encoder_matches_jax(name):
    """f32 end to end through subsampling + 2 blocks: 1e-3 absolute on
    activations of order 1 covers summation-order differences (observed
    below 1e-5) while any layout or index error is off by O(1)."""
    mel = _mel(3, 161, seed=0)
    lengths = np.array([161, 90, 33], np.int32)
    if name == "trained_tiny":
        cfg, params = TINY, _trained_tiny_params()
    else:
        cfg, params = DH128, _perturbed_init(DH128, mel, lengths)
    want, want_len, got, got_len = _both(cfg, params, mel, lengths)
    np.testing.assert_array_equal(got_len, want_len)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    for b, n in enumerate(got_len):
        assert not got[b, n:].any()


def test_every_block_calls_the_attention_wrapper():
    """The encoder routes each layer's full-context attention through the
    wrapper (on CUDA that is the kernel): one call per block, in the
    [B, H, T, Dh] layout with the per-row key lengths."""
    cfg = port.ConformerConfig(**DH128)
    enc = port.ConformerEncoder(cfg).eval()
    mel = torch.from_numpy(_mel(2, 81, seed=2))
    lengths = torch.tensor([81, 40], dtype=torch.int32)
    calls = []

    def counting(qu, qw, k, v, p, lens, t_real, **kw):
        calls.append((tuple(qu.shape), tuple(p.shape), lens.tolist(), t_real))
        return relpos_attention(qu, qw, k, v, p, lens, t_real, **kw)

    ref, _ = enc(mel, lengths)
    got, out_len = enc(mel, lengths, attention=counting)
    T = cfg.out_length(81)
    assert len(calls) == cfg.n_layers
    assert calls[0] == ((2, 2, T, 128), (2, 2 * T - 1, 128), out_len.tolist(), T)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_rel_sinusoid_matches_jax():
    want = np.asarray(jax_conformer._rel_sinusoid(23, 64))
    got = port.rel_sinusoid(23, 64).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_out_length_matches_jax():
    a = jax_conformer.ConformerConfig()
    b = port.ConformerConfig()
    for n in (1, 2, 7, 8, 9, 100, 1501):
        assert b.out_length(n) == a.out_length(n)


# the head widths of the dispatch: Cohere's trained fixture (d 32, 4 heads,
# Dh 8) and full width (d 1280, 8 heads, Dh 160) lie outside the kernel's
# range; Dh 16 and 128 inside it
MHSA_WIDTHS = {"dh8": (32, 4), "dh16": (64, 4), "dh128": (256, 2), "dh160": (1280, 8)}


def _mhsa_pair(d_model, n_heads, B=2, T=19, seed=4):
    """A JAX RelPosMHSA with perturbed parameters and the port's module on
    the same parameters, plus a seeded input, key lengths and JAX's mask."""
    cfg = dict(d_model=d_model, n_heads=n_heads, dtype="float32")
    jax_mhsa = jax_conformer.RelPosMHSA(jax_conformer.ConformerConfig(**cfg))
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, d_model).astype(np.float32)
    lengths = np.array([T, T - 7][:B], np.int32)
    pad = np.arange(T)[None, :] < lengths[:, None]
    att = pad[:, None, :] & pad[:, :, None]
    params = jax_mhsa.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(att),
                           jnp.asarray(lengths))
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rs.randn(*p.shape).astype(np.float32), params)
    port_mhsa = port.RelPosMHSA(port.ConformerConfig(**cfg)).eval()
    load_state(port_mhsa, from_jax_params(params))
    return jax_mhsa, params, port_mhsa, x, lengths, att


@pytest.mark.parametrize("width", list(MHSA_WIDTHS))
def test_mhsa_dispatches_by_head_width_and_matches_jax(width, monkeypatch):
    """`RelPosMHSA.forward` branches on Dh before any launch: the kernel's
    wrapper where the kernel takes Dh (16..128), the plain version
    elsewhere (Dh 8, 160), as the JAX module branches between Pallas and
    einsum. On the CPU both give the JAX einsum path's output on valid
    query rows (padded rows are masked downstream)."""
    d_model, n_heads = MHSA_WIDTHS[width]
    jax_mhsa, params, port_mhsa, x, lengths, att = _mhsa_pair(d_model, n_heads)
    wrapper_calls = []

    def spy(*args, **kw):
        wrapper_calls.append(args[0].shape[-1])
        return relpos_attention(*args, **kw)

    monkeypatch.setattr(port, "relpos_attention", spy)
    T = x.shape[1]
    pos = port.rel_sinusoid(T, d_model)
    plain_before = port.relpos_attention_plain.calls
    with torch.no_grad():
        got = port_mhsa(torch.from_numpy(x), pos, torch.from_numpy(lengths)).numpy()
    want = np.asarray(jax_mhsa.apply(params, jnp.asarray(x), jnp.asarray(att),
                                     jnp.asarray(lengths)))
    in_range = port.kernel_takes_head_dim(d_model // n_heads)
    assert in_range == (width in ("dh16", "dh128"))
    assert wrapper_calls == ([d_model // n_heads] if in_range else [])
    assert port.relpos_attention_plain.calls == plain_before + 1  # the CPU runs plain
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("head_dim,takes", [(8, False), (15, False), (16, True), (64, True),
                                            (120, False), (128, True), (144, False),
                                            (160, False)])
def test_kernel_head_width_predicate(head_dim, takes):
    assert port.kernel_takes_head_dim(head_dim) is takes
