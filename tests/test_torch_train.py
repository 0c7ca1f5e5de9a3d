"""The port's training path against JAX: batches, losses, gradients, AdamW.

- `train/tiny_corpus.py`'s training batches (`asr_batch`, including its
  re-seeded trimming path, `vad_example`, `vad_batch`, `sortformer_batch`,
  `write_vocab_json`) are bit-equal to JAX's for the same
  `np.random.RandomState` seeds.
- The CTC and TDT steps' loss and gradients (`parallel.train.
  loss_and_grads`) against JAX's own train steps on the same parameters,
  carried over with `utils/weights.py`, at JAX's dryrun config (Dh 16) and
  at Dh 128 with `attention_backend="xla"`. JAX's gradients come out of its
  `make_train_step` through an optimizer that stores them as its state.
  Tolerances: the loss within 1e-5 relative; the whole gradient within 1e-5
  relative L2; each leaf within 2e-5 of its norm, floored at 1e-3 of the
  largest leaf's norm (the attention's key bias has a gradient that is zero
  but for rounding). Observed: 1.2e-6 whole, 2.6e-6 worst leaf.
- `AdamW`'s update against `optax.adamw` on the same gradients over three
  steps, within 1e-6 relative plus 1e-12 absolute: the same f32 arithmetic,
  rounded apart by an ulp or two. Parameters after a step are not compared
  across libraries (the first step is about lr * sign(g)).
- `ctc_loss` against `optax.ctc_loss`, with a row that no alignment fits.
- The attention route under a gradient on the CPU (the plain version at
  every Dh, no launch of a kernel's wrapper), and the refusals.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fluidaudio_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from fluidaudio_tpu.models.predictor import PredictorConfig as JaxPredictorConfig
from fluidaudio_tpu.parallel import train as jax_train
from fluidaudio_tpu.train import tiny_corpus as jax_tc
from fluidaudio_tpu_torch.models import conformer as port_conformer
from fluidaudio_tpu_torch.models.conformer import ConformerConfig
from fluidaudio_tpu_torch.models.predictor import PredictorConfig
from fluidaudio_tpu_torch.ops import int8_matmul
from fluidaudio_tpu_torch.parallel import train as port_train
from fluidaudio_tpu_torch.train import tiny_corpus as port_tc
from fluidaudio_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_custom_vocab import one_torch_thread  # noqa: F401

# ------------------------------------------------------------------ batches


@pytest.mark.parametrize("window", [240_000, 48_000], ids=["fits", "trims"])
def test_asr_batch_bit_equal(window):
    """At 3 s most utterances overflow the window: the re-seeded trimming."""
    want = jax_tc.asr_batch(np.random.RandomState(7), 4, window)
    got = port_tc.asr_batch(np.random.RandomState(7), 4, window)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    if window == 48_000:  # 3 s holds at most 6 words: longer draws were trimmed
        assert want["label_lengths"].max() <= 6 and (want["audio_lengths"] <= window).all()


def test_vad_example_and_batch_bit_equal():
    assert (port_tc.VAD_FRAME, port_tc.VAD_CONTEXT) == (jax_tc.VAD_FRAME, jax_tc.VAD_CONTEXT)
    for got, want in zip(port_tc.vad_example(np.random.RandomState(3), 40),
                         jax_tc.vad_example(np.random.RandomState(3), 40)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(port_tc.vad_batch(np.random.RandomState(5), 3, 64),
                         jax_tc.vad_batch(np.random.RandomState(5), 3, 64)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_sortformer_batch_bit_equal():
    for got, want in zip(port_tc.sortformer_batch(np.random.RandomState(9), 2, 1024),
                         jax_tc.sortformer_batch(np.random.RandomState(9), 2, 1024)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_write_vocab_json_equal(tmp_path):
    port_tc.write_vocab_json(tmp_path / "port.json")
    jax_tc.write_vocab_json(tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert json.loads((tmp_path / "port.json").read_text())["0"] == "▁w0"


# --------------------------------------------------- losses and gradients

DRYRUN = dict(n_mels=16, d_model=64, n_layers=2, n_heads=4, subsampling_channels=16,
              dtype="float32")
DH128_XLA = dict(n_mels=16, d_model=256, n_layers=2, n_heads=2, subsampling_channels=16,
                 dtype="float32", attention_backend="xla")
CONFIGS = {"dryrun": DRYRUN, "dh128_xla": DH128_XLA}
VOCAB, FRAMES = 32, 65


def _batch(seed: int = 0) -> dict:
    rs = np.random.RandomState(seed)
    return {"mel": rs.randn(4, 16, FRAMES).astype(np.float32),
            "mel_lengths": np.array([65, 50, 33, 60], np.int32),
            "labels": rs.randint(0, VOCAB, (4, 8)).astype(np.int32),
            "label_lengths": np.array([8, 5, 2, 6], np.int32)}


def _pred_kwargs(d_model: int) -> dict:
    return dict(vocab_size=VOCAB, pred_hidden=32, n_layers=1, enc_hidden=d_model,
                joint_hidden=32, n_durations=5)


def _recorder() -> optax.GradientTransformation:
    """An optimizer whose state becomes the gradients it is given (updates 0)."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _carry(tree) -> dict[str, np.ndarray]:
    """A JAX train state's tree ({"encoder": flax tree, ..., "ctc_head": array})
    -> {the port's dotted name: array in torch layout}."""
    out = {}
    for top, sub in tree.items():
        if isinstance(sub, dict):
            for k, v in from_jax_params(jax.tree.map(np.asarray, sub)).items():
                out[f"{top}.{k}"] = v
        else:
            out[top] = np.array(sub)
    return out


def _jax_loss_and_grads(kind: str, cfg_kwargs: dict, batch: dict):
    """JAX's own train step on its init; -> (params, loss, grads) carried."""
    cfg = JaxConformerConfig(**cfg_kwargs)
    if kind == "ctc":
        state, encoder, _ = jax_train.create_train_state(jax.random.PRNGKey(0), cfg, VOCAB,
                                                         FRAMES)
        step = jax_train.make_train_step(encoder, _recorder(), VOCAB)
    else:
        pcfg = JaxPredictorConfig(**_pred_kwargs(cfg.d_model))
        state, modules, _ = jax_train.create_tdt_train_state(jax.random.PRNGKey(1), cfg, pcfg,
                                                             FRAMES)
        step = jax_train.make_tdt_train_step(modules, pcfg, _recorder(), (0, 1, 2, 3, 4))
    state = state._replace(opt_state=_recorder().init(state.params))
    new, metrics = jax.jit(step)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return _carry(state.params), float(metrics["loss"]), _carry(new.opt_state)


def _port_state(kind: str, cfg_kwargs: dict, params: dict[str, np.ndarray]):
    gen = torch.Generator().manual_seed(0)
    cfg = ConformerConfig(**cfg_kwargs)
    if kind == "ctc":
        state, encoder, tx = port_train.create_train_state(gen, cfg, VOCAB, FRAMES, device="cpu")
        objective = port_train.CtcObjective(encoder, VOCAB)
    else:
        pcfg = PredictorConfig(**_pred_kwargs(cfg.d_model))
        state, modules, tx = port_train.create_tdt_train_state(gen, cfg, pcfg, FRAMES,
                                                               device="cpu")
        objective = port_train.TdtObjective(modules, pcfg, (0, 1, 2, 3, 4))
    assert sorted(state.params) == sorted(params)
    with torch.no_grad():
        for k, v in state.params.items():
            v.copy_(torch.from_numpy(params[k]))
    return state, objective, tx


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("kind", ["ctc", "tdt"])
def test_loss_and_grads_equal_jax(kind, config):
    batch = _batch()
    params, want_loss, want = _jax_loss_and_grads(kind, CONFIGS[config], batch)
    state, objective, _ = _port_state(kind, CONFIGS[config], params)
    loss, grads = port_train.loss_and_grads(objective, state.params, batch)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = {k: g.numpy() for k, g in grads.items()}
    assert sorted(got) == sorted(want)
    floor = 1e-3 * max(np.linalg.norm(w) for w in want.values())
    for k, w in want.items():
        assert np.linalg.norm(got[k] - w) <= 2e-5 * max(np.linalg.norm(w), floor), k
    whole = np.sqrt(sum(np.linalg.norm(got[k] - w) ** 2 for k, w in want.items()))
    assert whole <= 1e-5 * np.sqrt(sum(np.linalg.norm(w) ** 2 for w in want.values()))


def test_adamw_update_equals_optax():
    rs = np.random.RandomState(11)
    shapes = {"a.weight": (8, 4), "a.bias": (8,), "emb": (5, 3)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx_j = optax.adamw(1e-4)
    opt_j = tx_j.init({k: jnp.asarray(v) for k, v in params.items()})
    tx_p = port_train.AdamW(1e-4)
    p_torch = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt_p = tx_p.init(p_torch)
    p_jax = {k: jnp.asarray(v) for k, v in params.items()}
    for step in range(3):
        grads = {k: (rs.randn(*s) * 10.0 ** rs.randint(-9, 1)).astype(np.float32)
                 for k, s in shapes.items()}
        want, opt_j = tx_j.update({k: jnp.asarray(v) for k, v in grads.items()}, opt_j, p_jax)
        got, opt_p = tx_p.update({k: torch.from_numpy(v) for k, v in grads.items()}, opt_p,
                                 p_torch)
        for k in shapes:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-12, err_msg=f"step {step} {k}")
        p_jax = optax.apply_updates(p_jax, want)
        port_train.apply_updates(p_torch, got)
        # the next step starts from the same parameters in both
        p_torch = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in p_jax.items()}
    assert opt_p.count == 3


def test_ctc_loss_equals_optax_with_an_infeasible_row():
    """Row 1 has 6 labels for 4 frames: optax scores the impossible paths
    with log_epsilon, a finite loss, where `F.ctc_loss` gives inf."""
    rs = np.random.RandomState(13)
    B, T, K, N = 3, 4, 6, 6
    logits = rs.randn(B, T, K).astype(np.float32)
    labels = rs.randint(1, K, (B, N)).astype(np.int32)
    logit_pad = np.zeros((B, T), np.float32)
    logit_pad[2, 3:] = 1.0
    label_pad = np.ones((B, N), np.float32)
    label_pad[0, :2] = label_pad[1, :] = label_pad[2, :1] = 0.0
    want = np.asarray(optax.ctc_loss(jnp.asarray(logits), jnp.asarray(logit_pad),
                                     jnp.asarray(labels), jnp.asarray(label_pad), blank_id=0))
    lg = torch.tensor(logits, requires_grad=True)
    got = port_train.ctc_loss(lg, torch.from_numpy(logit_pad), torch.from_numpy(labels),
                              torch.from_numpy(label_pad), blank_id=0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6)
    assert np.isfinite(want[1]) and want[1] > 1e4
    got.sum().backward()
    assert np.all(np.isfinite(lg.grad.numpy()))


# ------------------------------------------------------ routes and refusals


@pytest.mark.parametrize("config", list(CONFIGS))
def test_train_step_takes_the_plain_attention_and_no_kernel(config, monkeypatch):
    """`"auto"` under a gradient on the CPU takes the plain version at every
    Dh, as JAX's CPU encoder takes einsum (`dryrun`: Dh 16, where serving
    takes the kernel's wrapper); neither kernel's wrapper is called, and a
    step lowers the loss of the batch it took."""
    cfg = dict(CONFIGS[config], attention_backend="auto")
    wrapper_calls = []
    monkeypatch.setattr(port_conformer, "relpos_attention",
                        lambda *a, **k: wrapper_calls.append(1))
    launches = int8_matmul.int8_matmul_fused.launches
    gen = torch.Generator().manual_seed(0)
    pcfg = PredictorConfig(**_pred_kwargs(cfg["d_model"]))
    state, modules, tx = port_train.create_tdt_train_state(gen, ConformerConfig(**cfg), pcfg,
                                                           FRAMES, device="cpu")
    step = port_train.make_tdt_train_step(modules, pcfg, tx, (0, 1, 2, 3, 4))
    plain = port_conformer.relpos_attention_plain.calls
    batch = _batch(3)
    losses = []
    for _ in range(3):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert port_conformer.relpos_attention_plain.calls == plain + 3 * cfg["n_layers"]
    assert wrapper_calls == [] and int8_matmul.int8_matmul_fused.launches == launches
    assert state.step == 3 and losses[-1] < losses[0]
    assert all(p.grad is None for p in modules[0].parameters())  # nothing accumulates


def test_serving_route_is_unchanged_without_a_gradient():
    enc = port_conformer.ConformerEncoder(ConformerConfig(**DRYRUN))
    mel = torch.zeros(1, 16, FRAMES)
    assert enc.attention_route(mel) is port_conformer.relpos_attention_plain  # trainable
    with torch.no_grad():
        assert enc.attention_route(mel) is None  # the kernel's wrapper where it takes Dh
    enc.requires_grad_(False)
    assert enc.attention_route(mel) is None


def test_train_and_eval_modes_compute_the_same_function():
    """Batch norm is JAX's folded form and there is no dropout: `train()`
    switches nothing to batch statistics."""
    enc = port_conformer.ConformerEncoder(ConformerConfig(**DRYRUN))
    mel = torch.from_numpy(_batch()["mel"])
    lengths = torch.from_numpy(_batch()["mel_lengths"])
    with torch.no_grad():
        a, _ = enc.train()(mel, lengths)
        b, _ = enc.eval()(mel, lengths)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("override,match", [({"dtype": "bfloat16"}, "float32"),
                                            ({"quantization": "int8"}, "float32")])
def test_untrainable_configs_are_refused(override, match):
    cfg = ConformerConfig(**dict(DRYRUN, **override))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match=match):
        port_train.create_train_state(gen, cfg, VOCAB, FRAMES, device="cpu")
    with pytest.raises(ValueError, match=match):
        port_train.create_tdt_train_state(gen, cfg, PredictorConfig(**_pred_kwargs(64)), FRAMES,
                                          device="cpu")
