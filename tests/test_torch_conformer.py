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
    with torch.no_grad():  # serving
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


PRESETS = [("models.conformer", n) for n in ("PARAKEET_V3", "PARAKEET_V2", "PARAKEET_110M",
                                              "EOU_120M")]
PRESETS += [("models.predictor", n) for n in ("PARAKEET_V3_PRED", "PARAKEET_V2_PRED",
                                               "EOU_PRED")]
PRESETS += [("ops.mel", n) for n in ("NEMO_PARAKEET", "NEMO_EOU")]


@pytest.mark.parametrize("module,name", PRESETS, ids=[n for _, n in PRESETS])
def test_preset_equals_jax(module, name):
    """Each of JAX's nine preset constants exists in the same port module,
    every field equal (`dataclasses.asdict`)."""
    import dataclasses
    import importlib

    want = getattr(importlib.import_module(f"fluidaudio_tpu.{module}"), name)
    got = getattr(importlib.import_module(f"fluidaudio_tpu_torch.{module}"), name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got).__name__ == type(want).__name__


def test_xla_backend_equals_jax_xla_encoder(monkeypatch):
    """`attention_backend="xla"` is JAX's einsum path: the plain version at
    every head width (here Dh 128, where "auto" takes the kernel's wrapper),
    never the wrapper, with or without a gradient; its output equals JAX's
    "xla" encoder at `test_encoder_matches_jax`'s tolerance. Any other
    value is refused."""
    cfg = dict(DH128, attention_backend="xla")
    mel = _mel(3, 161, seed=0)
    lengths = np.array([161, 90, 33], np.int32)
    params = _perturbed_init(DH128, mel, lengths)
    monkeypatch.setattr(port, "relpos_attention", None)  # the wrapper is never called
    plain_before = port.relpos_attention_plain.calls
    want, want_len, got, got_len = _both(cfg, params, mel, lengths)
    assert port.relpos_attention_plain.calls == plain_before + DH128["n_layers"]
    np.testing.assert_array_equal(got_len, want_len)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    with pytest.raises(ValueError, match="'auto' or 'xla'"):
        port.ConformerEncoder(port.ConformerConfig(**DH128, attention_backend="pallas"))


# (left, right) frames of limited attention context: EOU_120M's (70, 0) at
# T' 76 > 70, so the left limit bites, and two narrow bands
CONTEXTS = [(70, 0), (2, 1), (3, 0)]


@pytest.mark.parametrize("left,right", CONTEXTS)
def test_limited_context_encoder_matches_jax(left, right, monkeypatch):
    """JAX's offline encoder masks keys outside [t - left, t + right] and
    takes its einsum path there; the port routes limited context to the
    plain attention over the same band, never to the kernel's wrapper (None
    here), one call per layer. Valid rows equal JAX's at
    `test_encoder_matches_jax`'s tolerance; the padded rows are zero; the
    full-context encoder on the same parameters differs, so the band is
    what is held."""
    cfg = dict(TINY, att_context_left=left, att_context_right=right)
    mel = _mel(3, 601, seed=5)
    lengths = np.array([601, 350, 130], np.int32)
    params = _perturbed_init(cfg, mel, lengths)
    monkeypatch.setattr(port, "relpos_attention", None)
    plain_before = port.relpos_attention_plain.calls
    want, want_len, got, got_len = _both(cfg, params, mel, lengths)
    assert port.relpos_attention_plain.calls == plain_before + TINY["n_layers"]
    np.testing.assert_array_equal(got_len, want_len)
    assert got.shape[1] == 76 and got_len.tolist() == [76, 44, 17]
    full, _ = jax_conformer.ConformerEncoder(jax_conformer.ConformerConfig(**TINY)).apply(
        params, jnp.asarray(mel), jnp.asarray(lengths))
    for b, n in enumerate(got_len):
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-3, rtol=1e-3)
        assert not got[b, n:].any()
    assert np.abs(np.asarray(full)[0] - want[0]).max() > 0.1


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_limited_context_route_is_the_plain_band(backend, monkeypatch):
    """The route is decided before any launch: limited context takes the
    plain attention over the band with either backend, served under
    `no_grad` and trained under autograd alike (the same output), and at
    Dh 128 on the card under a gradient too, where full context raises
    (JAX's `use_pallas` excludes limited context). An explicit attention
    function is refused: neither the kernel nor a bare plain call takes
    the band."""
    cfg = port.ConformerConfig(**TINY, att_context_left=3, att_context_right=0,
                               attention_backend=backend)
    enc = port.ConformerEncoder(cfg)
    mel = torch.from_numpy(_mel(2, 161, seed=6))
    lengths = torch.tensor([161, 90], dtype=torch.int32)
    monkeypatch.setattr(port, "relpos_attention", None)
    route = enc.attention_route(mel)  # a gradient is needed: the parameters require it
    assert route.func is port.relpos_attention_plain and route.keywords == {"context": (3, 0)}
    with torch.no_grad():
        served, _ = enc(mel, lengths)
    trained, _ = enc(mel, lengths)
    trained.sum().backward()
    assert enc.block0.mhsa.q.weight.grad is not None
    torch.testing.assert_close(trained.detach(), served, rtol=0, atol=0)
    with pytest.raises(ValueError, match="attention=None"):
        enc(mel, lengths, attention=port.relpos_attention_plain)

    card_mel = torch.empty(1, 128, 161, device="meta", requires_grad=True)
    wide = dict(DH128, attention_backend=backend)
    limited = port.ConformerEncoder(port.ConformerConfig(**wide, att_context_left=70,
                                                         att_context_right=0))
    assert limited.attention_route(card_mel).func is port.relpos_attention_plain
    if backend == "auto":
        with pytest.raises(ValueError, match="xla"):
            port.ConformerEncoder(port.ConformerConfig(**wide)).attention_route(card_mel)
