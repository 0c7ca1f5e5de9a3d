"""PocketTTS and the Mimi codec of the PyTorch port against the JAX package.

Mimi (MIMI_TEST, on JAX's seeded init loaded through `utils/weights.py`):
- the causal streaming Conv1d / ConvTranspose1d steps against the whole
  sequence at once, and against JAX's steps;
- `MimiDecoder.step` over 20 frames (the 16-frame ring KV cache wraps)
  against JAX's decoder frame by frame: REL_L2 per frame;
- streaming against full-sequence: the SEANet stack fed 20 frames at once
  equals it fed frame by frame, and the ring-KV transformer layer equals
  full-sequence causal attention over its window;
- `MimiEncoder` against JAX's on two clips.

PocketTTS (POCKET_TEST): `FlowLm.step` at several positions, `FlowLm.prefill`
against JAX's step-by-step prefill scan (KV cache and conditioning), the
flow decoder: REL_L2.

The trained `pocket` fixture through both managers, the frame noise JAX's
own draws (`jax.random.normal(PRNGKey(seed), ...)`, and per stream block
JAX's key splits): equal frame counts and done flags (and no EOS logit within
EOS_MARGIN of the threshold), samples within REL_L2_AUDIO, `stream` and
`clone_voice` too; `eval_pocket_fixture(device="cpu")` with JAX's draws gives
JAX's numbers. The API cases of `tests/test_pocket_tts.py` and every case of
`tests/test_pocket_text.py` run on the port (`jax_cases`); the converter
cases of `test_pocket_tts.py` and `test_mimi.py` exercise the JAX package's
`convert/` (not ported), their model math is held here.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from fluidaudio_tpu.models import mimi as jmimi
from fluidaudio_tpu.models import pocket_tts as jpt
from fluidaudio_tpu.train import fixtures as jax_fx
from fluidaudio_tpu.train import tiny_corpus as tc
from fluidaudio_tpu_torch.models import mimi as pmimi
from fluidaudio_tpu_torch.models import pocket_tts as ppt
from fluidaudio_tpu_torch.train import fixtures as port_fx
from fluidaudio_tpu_torch.tts.pocket_manager import PocketTtsManager
from fluidaudio_tpu_torch.utils.weights import from_jax_params, load_state
from tests.test_torch_custom_vocab import jax_cases, jax_fixtures, one_torch_thread  # noqa: F401

REL_L2 = 1e-5
REL_L2_AUDIO = 1e-4
EOS_MARGIN = 1e-4
CFG = jmimi.MIMI_TEST


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(x):
    return torch.as_tensor(np.array(x))


def _load(module, params):
    load_state(module, from_jax_params(_np(params)))
    return module.eval()


def test_config_fields_are_jax_s():
    for port, jax_cls in ((ppt.PocketTtsConfig, jpt.PocketTtsConfig),
                          (pmimi.MimiConfig, jmimi.MimiConfig)):
        assert [f.name for f in dataclasses.fields(port)] == [
            f.name for f in dataclasses.fields(jax_cls)]
    assert repr(port_fx.pocket_tiny_config()).replace("fluidaudio_tpu_torch", "") == \
        repr(jax_fx.pocket_tiny_config()).replace("fluidaudio_tpu", "")
    assert dataclasses.asdict(ppt.POCKET_BASE) == dataclasses.asdict(jpt.POCKET_BASE)


# ------------------------------------------------------------------- Mimi


@pytest.mark.parametrize("k,stride,dil", [(5, 1, 2), (6, 3, 1), (1, 1, 1)])
def test_causal_conv_step_streams_like_the_whole_sequence(k, stride, dil):
    rs = np.random.RandomState(k)
    B, C, O, T = 2, 3, 5, 24
    x = torch.as_tensor(rs.randn(B, C, T).astype(np.float32))
    w = torch.as_tensor(rs.randn(O, C, k).astype(np.float32) * 0.3)
    b = torch.as_tensor(rs.randn(O).astype(np.float32))
    full, _ = pmimi.causal_conv_step(x, torch.zeros(B, C, pmimi.conv_state_size(k, stride, dil)),
                                     w, b, stride, dil)
    pad = (k - 1) * dil + 1 - stride
    np.testing.assert_allclose(full.numpy(), F.conv1d(F.pad(x, (pad, 0)), w, b, stride,
                                                      dilation=dil).numpy(), atol=1e-5)
    state, outs = torch.zeros(B, C, pmimi.conv_state_size(k, stride, dil)), []
    for t0 in range(0, T, 6):
        y, state = pmimi.causal_conv_step(x[:, :, t0:t0 + 6], state, w, b, stride, dil)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 2).numpy(), full.numpy(), atol=1e-5)
    # and JAX's step on the same chunks
    js, got = jnp.zeros((B, pmimi.conv_state_size(k, stride, dil), C)), []
    for t0 in range(0, T, 6):
        y, js = jmimi.causal_conv_step(jnp.asarray(x[:, :, t0:t0 + 6].numpy().transpose(0, 2, 1)),
                                       js, jnp.asarray(w.numpy().transpose(2, 1, 0)),
                                       jnp.asarray(b.numpy()), stride, dil)
        got.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(got, 1).transpose(0, 2, 1), full.numpy(), atol=1e-5)


def test_causal_convtr_step_streams_like_torch():
    rs = np.random.RandomState(1)
    B, C, O, k, s, T = 2, 4, 3, 8, 4, 12
    x = torch.as_tensor(rs.randn(B, C, T).astype(np.float32))
    w = torch.as_tensor(rs.randn(C, O, k).astype(np.float32) * 0.3)
    b = torch.as_tensor(rs.randn(O).astype(np.float32))
    ref = F.conv_transpose1d(x, w, b, stride=s)[:, :, : T * s]
    state, outs = torch.zeros(B, O, k - s), []
    for t0 in range(0, T, 3):
        y, state = pmimi.causal_convtr_step(x[:, :, t0:t0 + 3], state, w, b, s)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 2).numpy(), ref.numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def mimi_decoders():
    dec = jmimi.MimiDecoder(CFG)
    params = jax.jit(dec.init)(jax.random.PRNGKey(0), jnp.zeros((1, CFG.latent_dim)),
                               dec.init_state(1))
    params = _np(params)
    # non-trivial layer scales, so the transformer shows in the output
    for i in range(CFG.trans_layers):
        for key in ("layer_scale_1", "layer_scale_2"):
            params["params"][f"tr_{i}"][key] = np.full((CFG.dim,), 0.7, np.float32)
    return dec, params, _load(pmimi.MimiDecoder(pmimi.MIMI_TEST), params)


def test_mimi_decoder_steps_equal_jax(mimi_decoders):
    """20 frames, 2 rows, against JAX's decoder: the 16-frame ring KV cache
    wraps at frame 16."""
    dec, params, port = mimi_decoders
    lat = np.random.RandomState(2).randn(20, 2, CFG.latent_dim).astype(np.float32)
    step = jax.jit(dec.apply)
    js, ps = dec.init_state(2), port.init_state(2)
    for f in range(20):
        want, js = step(params, jnp.asarray(lat[f]), js)
        got, ps = port(_t(lat[f]), ps)
        assert got.shape == want.shape == (2, CFG.hop)
        assert _rel(got.numpy(), want) <= REL_L2, f
    assert int(ps["pos"][0]) == 20


def test_mimi_seanet_streams_like_the_whole_sequence(mimi_decoders):
    """The SEANet stack (after the transformer and the x2 upsample) fed 20
    frames of features at once equals it fed frame by frame, states carried."""
    _, _, port = mimi_decoders
    x = torch.as_tensor(np.random.RandomState(3).randn(1, CFG.dim, 40).astype(np.float32))

    def seanet(x, convs):
        convs, new = iter(convs), []

        def run(block, x):
            y, s = block(x, next(convs))
            new.append(s)
            return y

        x = run(port.conv_in, x)
        for i in range(len(CFG.ratios)):
            x = run(getattr(port, f"up_{i}"), F.elu(x))
            res = run(getattr(port, f"res_{i}_a"), F.elu(x))
            x = x + run(getattr(port, f"res_{i}_b"), F.elu(res))
        return run(port.conv_out, F.elu(x)), new

    with torch.no_grad():
        whole, _ = seanet(x, port.init_state(1)["convs"])
        convs, parts = port.init_state(1)["convs"], []
        for f in range(20):
            y, convs = seanet(x[:, :, 2 * f: 2 * f + 2], convs)
            parts.append(y)
    np.testing.assert_allclose(torch.cat(parts, 2).numpy(), whole.numpy(), atol=1e-5)


def test_ring_kv_layer_equals_full_sequence_attention(mimi_decoders):
    """The ring-KV layer frame by frame over 24 frames (ctx 16) against
    causal attention over the whole sequence within the same window."""
    _, _, port = mimi_decoders
    layer = port.tr_0
    T, D, H, Dh = 24, CFG.dim, CFG.trans_heads, CFG.head_dim
    x = torch.as_tensor(np.random.RandomState(4).randn(1, T, D).astype(np.float32))
    with torch.no_grad():
        kv, outs = torch.zeros(2, 1, CFG.trans_context, H, Dh), []
        for t in range(T):
            y, kv = layer(x[:, t:t + 1], torch.tensor([t]), kv)
            outs.append(y)
        q, k, v = layer.in_proj(layer.norm1(x)).chunk(3, dim=-1)
        pos = torch.arange(T)[None]
        q, k = pmimi.rope(q.reshape(1, T, H, Dh), pos), pmimi.rope(k.reshape(1, T, H, Dh), pos)
        ti = torch.arange(T)
        mask = (ti[:, None] >= ti[None, :]) & (ti[:, None] - ti[None, :] < CFG.trans_context)
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
        att = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc.masked_fill(~mask, -1e9), -1),
                           v.reshape(1, T, H, Dh)).reshape(1, T, D)
        y = x + layer.layer_scale_1 * layer.out_proj(att)
        want = y + layer.layer_scale_2 * layer.mlp_out(F.gelu(layer.mlp_in(layer.norm2(y)),
                                                              approximate="tanh"))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), want.numpy(), atol=1e-5)


def test_mimi_encoder_equals_jax():
    enc = jmimi.MimiEncoder(CFG)
    audio = np.random.RandomState(5).randn(2, CFG.hop * 7).astype(np.float32) * 0.3
    params = _np(jax.jit(enc.init)(jax.random.PRNGKey(1), jnp.asarray(audio)))
    for i in range(CFG.trans_layers):
        params["params"][f"tr_{i}_ls1"] = np.full((CFG.dim,), 0.5, np.float32)
    want = np.asarray(jax.jit(enc.apply)(params, jnp.asarray(audio)))
    got = _load(pmimi.MimiEncoder(pmimi.MIMI_TEST), params)(_t(audio)).numpy()
    assert got.shape == want.shape == (2, 7, CFG.latent_dim)
    assert _rel(got, want) <= REL_L2


# --------------------------------------------------------------- flow-LM


@pytest.fixture(scope="module")
def flowlm():
    cfg = jpt.POCKET_TEST
    lm = jpt.FlowLm(cfg)
    params = jax.jit(lm.init)(jax.random.PRNGKey(2), jnp.zeros((1, cfg.d_model)),
                              jnp.zeros((1,), jnp.int32), jpt.init_kv(cfg, 1))
    return lm, _np(params), _load(ppt.FlowLm(ppt.POCKET_TEST), params)


def test_flowlm_steps_equal_jax(flowlm):
    lm, params, port = flowlm
    cfg = jpt.POCKET_TEST
    xs = np.random.RandomState(6).randn(6, 2, cfg.d_model).astype(np.float32)
    jkv, pkv = jpt.init_kv(cfg, 2), ppt.init_kv(ppt.POCKET_TEST, 2)
    step = jax.jit(lambda p, x, pos, kv: lm.apply(p, x, pos, kv, method=jpt.FlowLm.step))
    for t in range(6):
        pos = np.array([t, t + 3], np.int32)
        wh, we, jkv = step(params, jnp.asarray(xs[t]), jnp.asarray(pos), jkv)
        with torch.no_grad():
            gh, ge, pkv = port.step(_t(xs[t]), _t(pos).long(), pkv)
        assert _rel(gh.numpy(), wh) <= REL_L2 and _rel(ge.numpy(), we) <= REL_L2
    assert _rel(pkv.k.numpy(), jkv.k) <= REL_L2 and _rel(pkv.v.numpy(), jkv.v) <= REL_L2


def test_flowlm_prefill_equals_jax_step_by_step(flowlm):
    """The one-pass causal prefill against JAX's scan of steps: the last
    position's hidden and every written KV slot."""
    lm, params, port = flowlm
    cfg = jpt.POCKET_TEST
    n = 40
    seq = np.random.RandomState(7).randn(n, cfg.d_model).astype(np.float32)
    step = jax.jit(lambda p, x, pos, kv: lm.apply(p, x, pos, kv, method=jpt.FlowLm.step))
    kv = jpt.init_kv(cfg, 1)
    for t in range(n):
        hidden, _, kv = step(params, jnp.asarray(seq[t:t + 1]), jnp.asarray([t], jnp.int32), kv)
    with torch.no_grad():
        got, pkv = port.prefill(_t(seq)[None], ppt.init_kv(ppt.POCKET_TEST, 1))
    assert _rel(got.numpy(), hidden) <= REL_L2
    assert _rel(pkv.k[:, :, :n].numpy(), np.asarray(kv.k)[:, :, :n]) <= REL_L2
    assert _rel(pkv.v[:, :, :n].numpy(), np.asarray(kv.v)[:, :, :n]) <= REL_L2


def test_flow_decoder_equals_jax():
    cfg = jpt.POCKET_TEST
    fd = jpt.FlowDecoder(cfg)
    rs = np.random.RandomState(8)
    cond = rs.randn(3, cfg.d_model).astype(np.float32)
    noise = rs.randn(3, cfg.mimi.latent_dim).astype(np.float32)
    params = jax.jit(fd.init)(jax.random.PRNGKey(3), cond, noise)
    want = fd.apply(params, cond, noise)
    got = _load(ppt.FlowDecoder(ppt.POCKET_TEST), params)(_t(cond), _t(noise))
    assert _rel(got.detach().numpy(), want) <= REL_L2


# ---------------------------------------------------------- trained fixture


def _jax_frame_noise(seed, n, latent):
    return torch.as_tensor(np.array(jax.random.normal(jax.random.PRNGKey(seed), (n, latent))))


def _jax_block_noises(seed, n_blocks, frames, latent):
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_blocks):
        key, sub = jax.random.split(key)
        out.append(torch.as_tensor(np.array(jax.random.normal(sub, (frames, latent)))))
    return out


@pytest.fixture()
def jax_noise(monkeypatch):
    """The port's managers draw JAX's frame noise."""
    monkeypatch.setattr(PocketTtsManager, "frame_noise", lambda self, seed, n: _jax_frame_noise(
        seed, n, self.cfg.mimi.latent_dim).to(self.device))


@pytest.fixture(scope="module")
def managers():
    return jax_fx.load_pocket_manager(), port_fx.load_pocket_manager(device="cpu")


@pytest.mark.parametrize("ids", [[3, 7, 12], [15, 0], [5, 9, 2, 14, 1, 8]])
def test_trained_fixture_equals_jax(managers, jax_noise, ids):
    """Frame counts and done flags equal (and no EOS logit within EOS_MARGIN
    of the threshold, where the last ulps could flip a flag), the samples
    within REL_L2_AUDIO."""
    jm, pm = managers
    text = tc.transcript_text(np.asarray(ids))
    tokens = pm._tokenize(text)
    np.testing.assert_array_equal(tokens, np.asarray(jm._tokenize(text)))
    kv, pos, cond = pm.prefill(tokens, pm.voices["default"])
    jkv, jpos, jcond = jm._prefill(jnp.asarray(tokens, jnp.int32),
                                   jnp.asarray(jm.voices["default"]))
    assert pos == int(jpos) and _rel(cond[0].numpy(), jcond) <= REL_L2
    n = pm.cfg.max_frames
    noise = _jax_frame_noise(0, n, pm.cfg.mimi.latent_dim)
    want_audio, want_done = jm._generate_jit(jm.params, jkv, jpos, jcond, n, jnp.asarray(noise))
    audio, done, eos = pm.generate(kv, pos, cond, noise)
    np.testing.assert_array_equal(done, np.asarray(want_done))
    margin = float(np.abs(eos - jpt.EOS_THRESHOLD).min())
    assert margin > EOS_MARGIN, f"an EOS logit lies {margin} from the threshold"
    assert _rel(audio, want_audio) <= REL_L2_AUDIO
    want, got = jm.synthesize(text), pm.synthesize(text)
    assert got.frames == want.frames and got.samples.shape == want.samples.shape
    assert _rel(got.samples, want.samples) <= REL_L2_AUDIO


def test_stream_and_clone_voice_equal_jax(managers, monkeypatch):
    jm, pm = managers
    text = tc.transcript_text(np.asarray([1, 8]))
    blocks = iter(_jax_block_noises(0, 10, pm.STREAM_BLOCK_FRAMES, pm.cfg.mimi.latent_dim))
    monkeypatch.setattr(pm, "block_noise", lambda gen: next(blocks))
    want = np.concatenate(list(jm.stream(text)))
    got = np.concatenate(list(pm.stream(text)))
    assert got.shape == want.shape and _rel(got, want) <= REL_L2_AUDIO
    ref = jax_fx.pocket_voice_reference()
    jm.clone_voice(ref, "cloned")
    pm.clone_voice(ref, "cloned")
    assert _rel(pm.voices["cloned"], jm.voices["cloned"]) <= REL_L2


def test_eval_pocket_fixture_equals_jax(managers, jax_noise, monkeypatch):
    """`eval_pocket_fixture` on the port with JAX's frame noise: JAX's
    roundtrip WERs (clone included)."""
    got = port_fx.eval_pocket_fixture(device="cpu")
    monkeypatch.setattr(jax_fx, "load_pocket_manager", lambda: managers[0])  # the same weights
    want = jax_fx.eval_pocket_fixture()
    assert got["roundtrip_wer_avg"] == pytest.approx(want["roundtrip_wer_avg"], abs=1e-12)
    assert got["clone_roundtrip_wer"] == pytest.approx(want["clone_roundtrip_wer"], abs=1e-12)
    assert len(got["utterances"]) == 4


def test_frame_program_scan_equals_its_frames(managers):
    """`FrameProgram.scan` over n frames equals n single frames, state
    carried, and the state it returns continues the run."""
    _, pm = managers
    kv, pos, cond = pm.prefill(pm._tokenize("w3 w4"), pm.voices["default"])
    noise = torch.randn((6, pm.cfg.mimi.latent_dim), generator=torch.Generator().manual_seed(1))
    audio, done, eos, state = pm.frame_program.scan(noise[:3], pm.initial_state(kv, pos, cond))
    audio2, _, _, _ = pm.frame_program.scan(noise[3:], state)
    whole, _, _, _ = pm.frame_program.scan(noise, pm.initial_state(kv, pos, cond))
    np.testing.assert_array_equal(torch.cat([audio, audio2]).numpy(), whole.numpy())


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        PocketTtsManager(ppt.POCKET_TEST)


# ------------------------------------------------- the JAX suites' own cases

POCKET_EDITS = (("PocketTtsManager(POCKET_TEST)", 'PocketTtsManager(POCKET_TEST, device="cpu")'),
                ("PocketTtsManager(POCKET_TEST, checkpoint_dir=tmp_path)",
                 'PocketTtsManager(POCKET_TEST, checkpoint_dir=tmp_path, device="cpu")'))
_CONVERTERS = ("test_pocket_converters_tree_match_and_run", "test_flowlm_kv_step_matches_full")
POCKET_CASES = [c for c in jax_cases("test_pocket_tts.py", ("tts", "models.pocket_tts"),
                                     edits=POCKET_EDITS, fixtures=True)
                if not c.id.startswith(_CONVERTERS)]
TEXT_CASES = jax_cases("test_pocket_text.py", ("tts",), fixtures=True, params=True)
globals().update(jax_fixtures("test_pocket_tts.py", ("tts", "models.pocket_tts"),
                              edits=POCKET_EDITS))


@pytest.mark.parametrize("case", POCKET_CASES + TEXT_CASES)
def test_jax_pocket_case_on_the_port(case, request):
    case(request)


def test_cases_cover_the_jax_suites():
    assert len(POCKET_CASES) == 19 - 2 and len(TEXT_CASES) >= 41
