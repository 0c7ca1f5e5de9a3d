"""The int8 (w8a8) path of the PyTorch port against the JAX package.

Inputs come from numpy seeds and go through both. On the CPU the port's
`int8_matmul_fused` runs its plain version; the JAX side runs the Pallas
kernel in interpret mode and `Int8Dense` on XLA. Quantisation, the integer
product and the dequantisation round at the same places as JAX op by op, so
the module outputs are compared exactly; jitted XLA:CPU code (the Pallas
interpret run) divides by the reciprocal and contracts into FMAs, so it is
held within 2 ulp; the encoders, which add LayerNorm, attention and
convolutions in another summation order, by relative L2.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax.traverse_util import unflatten_dict

from fluidaudio_tpu.asr.config import ASRConfig as JaxASRConfig
from fluidaudio_tpu.asr.manager import AsrManager as JaxAsrManager
from fluidaudio_tpu.models import conformer as jax_conformer
from fluidaudio_tpu.models.zoo import AsrModels as JaxAsrModels
from fluidaudio_tpu.ops import quant as jq
from fluidaudio_tpu.ops.quant_pallas import int8_matmul_fused as jax_fused
from fluidaudio_tpu.train.fixtures import trained_assets_dir
from fluidaudio_tpu_torch.asr.config import ASRConfig
from fluidaudio_tpu_torch.asr.manager import AsrManager
from fluidaudio_tpu_torch.models import conformer as port
from fluidaudio_tpu_torch.models.zoo import ASR_VERSIONS, AsrModels
from fluidaudio_tpu_torch.ops import int8_matmul as kmod
from fluidaudio_tpu_torch.ops import quant
from fluidaudio_tpu_torch.train import tiny_corpus as tc
from fluidaudio_tpu_torch.utils.weights import from_jax_params, load_state
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

CKPT = trained_assets_dir() / "asr"
TINY = dict(d_model=64, n_layers=2, n_heads=4, subsampling_channels=32, dtype="float32")
DH128 = dict(d_model=256, n_layers=2, n_heads=2, subsampling_channels=32, dtype="float32")
# the two shapes of tests/test_quant_pallas.py: (M, K, N, bias, weight scale, seed)
PALLAS_CASES = {"100x256x192_bias": (100, 256, 192, True, 0.05, 0),
                "37x128x130_ragged": (37, 128, 130, False, 0.1, 1)}


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def _case(name):
    M, K, N, with_bias, w_scale, seed = PALLAS_CASES[name]
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) * w_scale).astype(np.float32)
    bias = rng.randn(N).astype(np.float32) if with_bias else None
    return x, w, bias


# ------------------------------------------------------------ quantisation


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(37, 128), (100, 256), (5, 4096)])
def test_quantize_rows_matches_jax(shape, dtype):
    """Codes and scales equal: amax is exact, and both divide in IEEE f32
    and round half to even. Scaled rows put many values near .5 boundaries."""
    rs = np.random.RandomState(sum(shape))
    x = (rs.randn(*shape) * rs.choice([1e-3, 1.0, 40.0], size=(shape[0], 1))).astype(np.float32)
    x[0] = 0.0  # the 1e-8 floor
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qj, sj = jq.quantize_rows(xj)
    qt, st = quant.quantize_rows(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("shape", [(64, 256), (1024, 4096), (130, 7)])
def test_quantize_cols_matches_jax(shape):
    rs = np.random.RandomState(shape[0])
    w = (rs.randn(*shape) * 0.05).astype(np.float32)
    w[:, 0] = 0.0
    qj, sj = jq.quantize_cols(jnp.asarray(w))
    qt, st = quant.quantize_cols(torch.from_numpy(w))
    assert tuple(st.shape) == (1, shape[1])
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_int8_matmul_matches_jax():
    rs = np.random.RandomState(7)
    x = rs.randn(3, 11, 64).astype(np.float32)
    w = (rs.randn(64, 48) * 0.1).astype(np.float32)
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = quant.int8_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.shape == (3, 11, 48)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------- the fused int8 matmul


def _port_fused(x, wq_kn, ws, bias, dtype, out_dtype):
    """The port's wrapper on CPU tensors, in its [N, K] / [N] layout."""
    return kmod.int8_matmul_fused(
        torch.from_numpy(x).to(dtype), torch.from_numpy(np.ascontiguousarray(wq_kn.T)),
        torch.from_numpy(np.array(ws.reshape(-1))),
        None if bias is None else torch.from_numpy(bias), out_dtype)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_fused_plain_matches_pallas_interpret(case, out):
    """Against the Pallas kernel in interpret mode. Its jitted XLA:CPU
    program divides by 127 as a multiply by the f32 reciprocal (a row scale
    1 ulp off in a few rows) and contracts `acc * s_row * s_col + bias` into
    an FMA, where the port rounds the IEEE quotient and each product and sum
    (JAX's own op-by-op result: `test_int8_linear_matches_int8dense` holds
    that exactly). So: the same int8 codes, and outputs within 2 ulp of the
    largest output in the output type (observed: 1 f32 ulp, bf16 equal)."""
    x, w, bias = _case(case)
    wq, ws = (np.asarray(a) for a in jq.quantize_cols(jnp.asarray(w)))
    want = jax_fused(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws),
                     None if bias is None else jnp.asarray(bias), block_m=32, block_n=128,
                     out_dtype=getattr(jnp, out), interpret=True)
    before = kmod.int8_matmul_fused.launches
    got = _port_fused(x, wq, ws, bias, torch.float32, getattr(torch, out))
    assert kmod.int8_matmul_fused.launches == before  # CPU: the plain version
    assert got.dtype == getattr(torch, out) and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(quant.quantize_rows(torch.from_numpy(x))[0].numpy(),
                                  np.asarray(jax.jit(jq.quantize_rows)(jnp.asarray(x))[0]))
    top = np.abs(_np(want)).max()
    ulp = np.spacing(np.float32(top)) * (2.0 ** 16 if out == "bfloat16" else 1.0)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2 * ulp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_int8_linear_matches_int8dense(case, dtype):
    """`Int8Linear` (weights through `from_jax_params`) against JAX
    `Int8Dense.apply` on the same pre-quantised params, x and output in the
    compute dtype: exact in f32, bf16 equal after the same rounding."""
    x, w, bias = _case(case)
    wq, ws = jq.quantize_cols(jnp.asarray(w))
    params = {"kernel_q": wq, "kernel_scale": ws}
    if bias is not None:
        params["bias"] = jnp.asarray(bias)
    jdt = getattr(jnp, dtype)
    want = jq.Int8Dense(w.shape[1], use_bias=bias is not None, dtype=jdt).apply(
        {"params": params}, jnp.asarray(x).astype(jdt)[None])[0]
    layer = quant.Int8Linear(w.shape[0], w.shape[1], bias=bias is not None,
                             out_dtype=getattr(torch, dtype)).to(getattr(torch, dtype))
    load_state(layer, from_jax_params({k: np.asarray(v) for k, v in params.items()}))
    got = layer(torch.from_numpy(x).to(getattr(torch, dtype))[None])[0]
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_fused_plain_is_exact_for_large_accumulators():
    """|acc| up to K * 127^2 = 6.6e7 > 2^24 at K = 4096: the float64
    accumulation of the plain version equals the int32 product."""
    rs = np.random.RandomState(3)
    x = np.sign(rs.randn(4, 4096)).astype(np.float32)  # every code is +-127
    wq = np.where(x[:1].T > 0, 127, -127).astype(np.int8).repeat(3, axis=1)  # [K, 3]
    got = _port_fused(x, wq, np.ones((1, 3), np.float32), None, torch.float32, torch.float32)
    xq = np.asarray(jq.quantize_rows(jnp.asarray(x))[0]).astype(np.int64)
    acc = xq @ wq.astype(np.int64)
    assert acc.max() == 4096 * 127 * 127
    want = acc.astype(np.float32) * np.asarray(jq.quantize_rows(jnp.asarray(x))[1])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", ["k_mismatch", "ws_shape", "bias_shape", "wq_dtype", "x_rank",
                                 "device"])
def test_wrapper_rejects_bad_arguments(bad):
    M, K, N = 4, 32, 8
    x = torch.zeros(M, K)
    wq = torch.zeros(N, K, dtype=torch.int8)
    ws, bias = torch.ones(N), torch.zeros(N)
    if bad == "k_mismatch":
        wq = torch.zeros(N, K + 16, dtype=torch.int8)
    elif bad == "ws_shape":
        ws = torch.ones(1, N)
    elif bad == "bias_shape":
        bias = torch.zeros(N + 1)
    elif bad == "wq_dtype":
        wq = wq.float()
    elif bad == "x_rank":
        x = x[None]
    elif bad == "device":
        x, wq, ws, bias = (t.to("meta") for t in (x, wq, ws, bias))
    with pytest.raises(ValueError):
        kmod.int8_matmul_fused(x, wq, ws, bias)


def test_kernel_module_imports_without_cuda():
    """Importing the wrapper neither builds nor loads the CUDA library."""
    assert kmod.load_library.cache_info().currsize == 0
    assert kmod.KERNEL_SOURCE.exists()
    src = kmod.KERNEL_SOURCE.read_text()
    assert "int8_matmul_fused_launch" in src
    # one GEMM: wgmma on s8 operands that TMA brings into an mbarrier-guarded ring
    assert ".s32.s8.s8" in src and "wgmma.mma_async" in src and "mma.sync" not in src
    assert "cp.async.bulk.tensor" in src and "mbarrier.try_wait" in src


# ------------------------------------------------------- weights and layers


def _trained_tree():
    with np.load(CKPT / "encoder.npz") as data:
        return unflatten_dict({tuple(k.split("/")): data[k] for k in data.files})


def _int8_encoder(cfg_kwargs, params_jax_int8):
    enc = port.ConformerEncoder(port.ConformerConfig(**cfg_kwargs, quantization="int8")).eval()
    load_state(enc, from_jax_params(params_jax_int8))  # raises on a key left over
    return enc


def test_weights_carry_over_both_ways():
    """`quantize_linear_state(from_jax_params(f32))` and
    `from_jax_params(quantize_dense_tree(f32))` give identical buffers, and
    the JAX int8 tree loads into the int8 encoder with every key used."""
    tree = _trained_tree()
    via_jax = from_jax_params(jax.tree_util.tree_map(np.asarray, jq.quantize_dense_tree(tree)))
    via_port = quant.quantize_linear_state(from_jax_params(tree))
    assert sorted(via_jax) == sorted(via_port)
    for k in via_jax:
        assert via_port[k].dtype == torch.from_numpy(via_jax[k]).dtype, k
        np.testing.assert_array_equal(via_port[k].numpy(), via_jax[k], err_msg=k)
    enc = _int8_encoder(TINY, jq.quantize_dense_tree(tree))
    n_int8 = sum(isinstance(m, quant.Int8Linear) for m in enc.modules())
    assert n_int8 == 11 * TINY["n_layers"] + 1
    assert sum(k.endswith("weight_q") for k in via_jax) == n_int8
    own = enc.state_dict()
    assert len(own) == len(via_jax)
    for k, v in via_port.items():
        np.testing.assert_array_equal(own[k].numpy(), v.numpy(), err_msg=k)


def test_quantize_linear_state_on_a_bare_layer():
    """Top-level keys (a lone layer's state) keep their names: `weight`
    becomes `weight_q` and `weight_scale`, 1-D entries pass through."""
    rs = np.random.RandomState(5)
    w, b = (rs.randn(48, 64) * 0.1).astype(np.float32), rs.randn(48).astype(np.float32)
    state = quant.quantize_linear_state({"weight": w, "bias": b})
    assert sorted(state) == ["bias", "weight_q", "weight_scale"]
    layer = quant.Int8Linear(64, 48)
    layer.load_state_dict(state)
    qj, sj = jq.quantize_cols(jnp.asarray(w.T))
    np.testing.assert_array_equal(layer.weight_q.numpy(), np.asarray(qj).T)
    np.testing.assert_array_equal(layer.weight_scale.numpy(), np.asarray(sj).reshape(-1))
    np.testing.assert_array_equal(layer.bias.numpy(), b)


def test_v3_int8_encoder_has_265_int8_layers():
    """11 per block (FFN fc1/fc2 x 2, q/k/v/pos/out, pointwise1/2) x 24 + the
    subsampling projection, exactly the layers JAX builds with `_dense`."""
    cfg = ASR_VERSIONS["v3"].conformer
    enc = port.ConformerEncoder(port.ConformerConfig(**{**cfg.__dict__, "quantization": "int8"}),
                                device="meta")
    layers = [m for m in enc.modules() if isinstance(m, quant.Int8Linear)]
    assert len(layers) == 265
    assert not any(isinstance(m, torch.nn.Linear) for m in enc.modules())


def test_int8_linear_keeps_f32_scale_and_bias_through_a_cast():
    layer = quant.Int8Linear(32, 8, out_dtype=torch.bfloat16)
    layer.weight_scale.fill_(1.0 + 2.0 ** -20)  # not representable in bf16
    layer = layer.to(torch.bfloat16)
    assert layer.weight_scale.dtype == torch.float32 and layer.bias.dtype == torch.float32
    assert layer.weight_q.dtype == torch.int8
    assert float(layer.weight_scale[0]) == 1.0 + 2.0 ** -20
    enc = port.ConformerEncoder(port.ConformerConfig(**{**TINY, "dtype": "bfloat16"},
                                                     quantization="int8"))
    for m in enc.modules():
        if isinstance(m, quant.Int8Linear):
            assert m.weight_scale.dtype == torch.float32 and m.out_dtype == torch.bfloat16
    assert enc.block0.ffn1_ln.weight.dtype == torch.bfloat16


# ------------------------------------------------------------- the encoder


def _mel(B, T, seed):
    return np.random.RandomState(seed).randn(B, 128, T).astype(np.float32)


def _perturbed_f32_tree(cfg_kwargs, mel, lengths):
    enc = jax_conformer.ConformerEncoder(jax_conformer.ConformerConfig(**cfg_kwargs))
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(mel), jnp.asarray(lengths))
    rs = np.random.RandomState(1)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rs.randn(*x.shape).astype(np.float32), params)


@pytest.mark.parametrize("name", ["trained_tiny", "dh128"])
def test_int8_encoder_matches_jax(name):
    """The port's int8 encoder against JAX's (quantization="int8", jitted as
    the JAX package runs it) on the same `quantize_dense_tree` params, f32
    compute. LayerNorm and attention sum in another order, and one ulp can
    flip a code at a .5 boundary, so relative L2 <= 1e-3 (observed 1.8e-7 in
    both configurations: no code flipped)."""
    mel = _mel(3, 161, seed=0)
    lengths = np.array([161, 90, 33], np.int32)
    cfg = TINY if name == "trained_tiny" else DH128
    tree = _trained_tree() if name == "trained_tiny" else _perturbed_f32_tree(cfg, mel, lengths)
    qtree = jq.quantize_dense_tree(tree)
    jax_enc = jax_conformer.ConformerEncoder(
        jax_conformer.ConformerConfig(**cfg, quantization="int8"))
    want, want_len = jax.jit(jax_enc.apply)(qtree, jnp.asarray(mel), jnp.asarray(lengths))
    enc = _int8_encoder(cfg, qtree)
    got, got_len = enc(torch.from_numpy(mel), torch.from_numpy(lengths))
    want = np.asarray(want)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-3, rel
    for b, n in enumerate(got_len.numpy()):
        assert not got[b, n:].any()


def test_zoo_quantises_the_f32_weights_once_at_load():
    """`AsrModels.load(..., quantization="int8")` holds the codes of the f32
    checkpoint (not of a bf16 cast) and the predictor/joint untouched."""
    f32 = AsrModels.load("test-tiny", checkpoint_dir=CKPT, device="cpu", allow_random_init=False)
    i8 = AsrModels.load("test-tiny", checkpoint_dir=CKPT, device="cpu", allow_random_init=False,
                        dtype="bfloat16", quantization="int8")
    assert i8.spec.conformer.quantization == "int8" and i8.spec.conformer.dtype == "bfloat16"
    want = quant.quantize_linear_state(f32.encoder.state_dict())
    own = i8.encoder.state_dict()
    layers = [n for n, m in i8.encoder.named_modules() if isinstance(m, quant.Int8Linear)]
    assert len(layers) == 11 * 2 + 1
    for name in layers:
        for leaf in ("weight_q", "weight_scale", "bias"):
            k = f"{name}.{leaf}"
            if k in want:
                assert own[k].dtype == want[k].dtype, k
                torch.testing.assert_close(own[k], want[k], rtol=0, atol=0, msg=k)
    torch.testing.assert_close(i8.joint.out.weight, f32.joint.out.weight, rtol=0, atol=0)


# ----------------------------------------------------- the manager, end to end


@pytest.fixture(scope="module")
def int8_managers():
    jax_models = JaxAsrModels.load("test-tiny", checkpoint_dir=CKPT, allow_random_init=False,
                                   quantization="int8")
    port_models = AsrModels.load("test-tiny", checkpoint_dir=CKPT, device="cpu",
                                 allow_random_init=False, quantization="int8")
    return (JaxAsrManager(jax_models, JaxASRConfig(parallel_chunk_batch=2)),
            AsrManager(port_models, ASRConfig(parallel_chunk_batch=2)))


@pytest.mark.parametrize("n_words", [5, 40])
def test_int8_transcribe_matches_jax(int8_managers, n_words):
    """The `eval_asr_fixture` draws (seed 12345) through both int8 managers:
    the same text and tokens; 40 words take the chunked path."""
    jax_mgr, port_mgr = int8_managers
    rs = np.random.RandomState(12345)
    utts = {}
    for n in (5, 40):
        ids = rs.randint(0, tc.N_WORDS, size=n)
        utts[n] = (ids, tc.make_utterance(ids, rs))
    ids, audio = utts[n_words]
    want = jax_mgr.transcribe(audio)
    got = port_mgr.transcribe(audio)
    assert got.text == want.text
    assert [t.token_id for t in got.token_timings] == [t.token_id for t in want.token_timings]
    assert got.text == tc.transcript_text(ids)
