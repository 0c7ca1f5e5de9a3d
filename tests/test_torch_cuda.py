"""The port's CUDA kernels and their on-card paths (needs an NVIDIA GPU).

Every test here is marked `cuda` and skips without a card. The file imports
no JAX, so it also runs on a machine without it, without the suite's
conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from fluidaudio_tpu_torch.ops import attention as attn
from fluidaudio_tpu_torch.ops import int8_matmul as i8
from fluidaudio_tpu_torch.ops import quant

pytestmark = pytest.mark.cuda

TRAINED_ASR = Path(__file__).resolve().parents[1] / "fluidaudio_tpu" / "assets" / "trained_tiny" / "asr"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def _inputs(B, H, T, Dh, dtype, device, seed=0, scale=1.0):
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: (torch.randn(*s, generator=g, device=device) * scale).to(dtype)
    return rnd(B, H, T, Dh), rnd(B, H, T, Dh), rnd(B, H, T, Dh), rnd(B, H, T, Dh), rnd(
        H, 2 * T - 1, Dh)


@pytest.mark.parametrize("B,H,T,Dh,dtype,lengths", [
    (4, 8, 188, 128, torch.bfloat16, [188, 100, 17, 188]),  # v3, 15 s windows
    (2, 8, 188, 128, torch.float32, [188, 5]),
    (2, 4, 47, 16, torch.float32, [47, 20]),  # the trained test-tiny head width
    (3, 2, 40, 64, torch.float32, [40, 17, 1]),
    (2, 2, 300, 96, torch.bfloat16, [300, 33]),  # several key tiles past T=188
    (1, 1, 5, 32, torch.float32, [0]),  # every key masked: uniform average
    (3, 4, 47, 16, torch.bfloat16, [47, 20, 0]),
    (2, 3, 70, 48, torch.bfloat16, [1, 65]),
    # f32: the short-T kernel (T <= 16) and the tiled one on each side of it,
    # Sortformer's shapes, ragged lengths with 0
    (3, 2, 1, 16, torch.float32, [1, 0, 1]),
    (4, 8, 6, 64, torch.float32, [6, 3, 0, 1]),
    (2, 2, 16, 128, torch.float32, [16, 9]),
    (2, 2, 17, 80, torch.float32, [17, 0]),
    (2, 3, 33, 112, torch.float32, [33, 32]),
    (2, 8, 384, 64, torch.float32, [384, 129]),
])
def test_kernel_matches_plain(cuda, B, H, T, Dh, dtype, lengths):
    """Same inputs, f32 scores and softmax on both sides. f32: only summation
    order and exp rounding differ (~1e-6 on an H100), so 1e-3. bf16: the
    tensor-core path rounds probabilities to bf16 before P.V (relative
    2^-9 per term, as the Pallas kernel does); up to 3e-3 seen on an H100,
    so 1e-2."""
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-3
    qu, qw, k, v, p = _inputs(B, H, T, Dh, dtype, cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = attn.relpos_attention.launches
    got = attn.relpos_attention(qu, qw, k, v, p, lens, T)
    torch.cuda.synchronize()
    assert attn.relpos_attention.launches == before + 1
    want = attn.relpos_attention_plain(qu, qw, k, v, p, lens, T)
    assert got.dtype == torch.float32 and got.shape == (B, H, T, Dh)
    for b, n in enumerate(lengths):
        n = n or T  # a fully masked row averages over all T keys in both
        torch.testing.assert_close(got[b, :, :n], want[b, :, :n], atol=tol, rtol=tol)


def _strided_inputs(B, H, T, Dh, dtype, device, seed=0):
    """The encoder's call: [B, H, T, Dh] views of [B, T, H, Dh] projections and
    the [H, 2T-1, Dh] view of a [2T-1, H, Dh] position projection."""
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device=device).to(dtype)
    qu, qw, k, v = (rnd(B, T, H, Dh).transpose(1, 2) for _ in range(4))
    return qu, qw, k, v, rnd(2 * T - 1, H, Dh).transpose(0, 1)


@pytest.mark.parametrize("B,H,T,Dh,dtype,lengths", [
    (4, 8, 188, 128, torch.bfloat16, [188, 100, 17, 188]),  # the v3 encoder's call
    (2, 2, 300, 96, torch.bfloat16, [300, 0]),
    (3, 4, 47, 16, torch.bfloat16, [47, 20, 1]),
    (2, 4, 47, 16, torch.float32, [47, 20]),  # the trained test-tiny head width
    (2, 3, 70, 48, torch.float32, [0, 65]),
    (4, 8, 6, 64, torch.float32, [6, 0, 2, 5]),  # Sortformer's streaming chunks
    (2, 8, 384, 64, torch.float32, [384, 65]),  # Sortformer's offline windows
])
def test_kernel_on_strided_views_and_out(cuda, B, H, T, Dh, dtype, lengths):
    """Strided inputs and the [B, H, T, Dh] view of a [B, T, H, Dh] buffer as
    `out=`, f32 and bf16: the f32 result matches the plain version on the
    same views (tolerances of test_kernel_matches_plain), and the bf16 result
    is the kernel's own f32 result rounded to bf16, bit for bit (both run
    the same arithmetic up to the store)."""
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-3
    qu, qw, k, v, p = _strided_inputs(B, H, T, Dh, dtype, cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    want = attn.relpos_attention_plain(qu, qw, k, v, p, lens, T)
    outs = {}
    for out_dtype in (torch.float32, torch.bfloat16):
        buf = torch.full((B, T, H, Dh), float("nan"), dtype=out_dtype, device=cuda)
        before = attn.relpos_attention.launches
        got = attn.relpos_attention(qu, qw, k, v, p, lens, T, out=buf.transpose(1, 2))
        torch.cuda.synchronize()
        assert attn.relpos_attention.launches == before + 1
        assert got.data_ptr() == buf.data_ptr() and got.shape == (B, H, T, Dh)
        assert bool(torch.isfinite(buf).all())  # every row written, padded rows too
        outs[out_dtype] = got
    for b, n in enumerate(lengths):
        n = n or T  # a fully masked row averages over all T keys in both
        torch.testing.assert_close(outs[torch.float32][b, :, :n], want[b, :, :n], atol=tol,
                                   rtol=tol)
    torch.testing.assert_close(outs[torch.bfloat16], outs[torch.float32].bfloat16(),
                               rtol=0, atol=0)
    contiguous = attn.relpos_attention(*(x.contiguous() for x in (qu, qw, k, v, p)), lens, T)
    torch.testing.assert_close(outs[torch.float32], contiguous, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shift_only_probe(cuda, dtype):
    """q.k = 0: peaked position scores alone pick the key, so a wrong XL
    index moves the output by O(1), far beyond the dtype's tolerance."""
    T = 24
    g = torch.Generator(device=cuda).manual_seed(2)
    qw = (torch.randn(1, 1, T, 128, generator=g, device=cuda) * 2.0).to(dtype)
    p = (torch.randn(1, 2 * T - 1, 128, generator=g, device=cuda) * 2.0).to(dtype)
    v = torch.randn(1, 1, T, 128, generator=g, device=cuda).to(dtype)
    z = torch.zeros_like(qw)
    lens = torch.tensor([T], dtype=torch.int32, device=cuda)
    got = attn.relpos_attention(z, qw, z, v, p, lens, T)
    torch.cuda.synchronize()
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-3
    torch.testing.assert_close(got, attn.relpos_attention_plain(z, qw, z, v, p, lens, T),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("bad", ["float16", "dh8", "dh144", "noncontiguous", "int64_lengths",
                                 "misaligned", "stride_not_16_bytes", "out_float16",
                                 "out_noncontiguous", "out_misaligned"])
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda, bad):
    B, H, T, Dh = 2, 2, 8, 144 if bad == "dh144" else (8 if bad == "dh8" else 32)
    dtype = torch.float16 if bad == "float16" else torch.float32
    qu, qw, k, v, p = _inputs(B, H, T, Dh, dtype, cuda)
    lens = torch.full((B,), T, dtype=torch.int64 if bad == "int64_lengths" else torch.int32,
                      device=cuda)
    out = None
    if bad == "noncontiguous":  # the last axis must be contiguous
        k = torch.randn(B, H, T, 2 * Dh, device=cuda)[..., ::2]
    elif bad == "misaligned":  # TMA reads from 16-byte boundaries
        flat = torch.zeros(B * H * T * Dh + 1, dtype=torch.bfloat16, device=cuda)
        qu, qw, k, v = (x.bfloat16() for x in (qu, qw, k, v))
        p = p.bfloat16()
        k = flat[1:].view(B, H, T, Dh)
    elif bad == "stride_not_16_bytes":  # rows of 34 floats: 136 bytes
        k = torch.randn(B, H, T, Dh + 2, device=cuda)[..., :Dh]
    elif bad == "out_float16":
        out = torch.empty(B, H, T, Dh, dtype=torch.float16, device=cuda)
    elif bad == "out_noncontiguous":
        out = torch.empty(B, H, T, 2 * Dh, device=cuda)[..., ::2]
    elif bad == "out_misaligned":
        out = torch.empty(B * H * T * Dh + 1, device=cuda)[1:].view(B, H, T, Dh)
    with pytest.raises(ValueError):
        attn.relpos_attention(qu, qw, k, v, p, lens, T, out=out)


def test_trained_fixture_encoder_and_transcript_match_cpu(cuda):
    """The trained test-tiny model (f32, Dh 16) on the card: every encoder
    layer launches the kernel, the encoder output matches the CPU run, and
    the transcript is the CPU's."""
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.zoo import AsrModels
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    on_card = AsrModels.load("test-tiny", checkpoint_dir=TRAINED_ASR, device=cuda,
                             allow_random_init=False)
    on_cpu = AsrModels.load("test-tiny", checkpoint_dir=TRAINED_ASR, device="cpu",
                            allow_random_init=False)
    rs = np.random.RandomState(12345)
    ids = rs.randint(0, tc.N_WORDS, size=5)
    audio = tc.make_utterance(ids, rs)
    x = torch.from_numpy(audio)[None]
    n = torch.tensor([audio.size], dtype=torch.int32)
    mel_c, len_c = on_cpu.mel(x, n)
    enc_c, _ = on_cpu.encoder(mel_c, len_c)
    before = attn.relpos_attention.launches
    mel_g, len_g = on_card.mel(x.to(cuda), n.to(cuda))
    enc_g, _ = on_card.encoder(mel_g, len_g)
    torch.cuda.synchronize()
    assert attn.relpos_attention.launches - before == on_card.spec.conformer.n_layers
    # f32 throughout with TF32 off; 1e-3 covers cuBLAS/cuDNN summation order
    torch.testing.assert_close(mel_g.cpu(), mel_c, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(enc_g.cpu(), enc_c, atol=1e-3, rtol=1e-3)
    text = AsrManager(on_card).transcribe(audio).text
    assert text == AsrManager(on_cpu).transcribe(audio).text == tc.transcript_text(ids)


# ------------------------------------------------------------ int8 matmul


def _int8_inputs(M, K, N, with_bias, x_dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(M, K, generator=g, device=device)
         * torch.rand(M, 1, generator=g, device=device) * 4).to(x_dtype)
    wq, ws = quant.quantize_cols(torch.randn(K, N, generator=g, device=device) * 0.05)
    bias = torch.randn(N, generator=g, device=device) if with_bias else None
    return x, wq.T.contiguous(), ws.reshape(-1), bias


@pytest.mark.parametrize("M,K,N,with_bias,x_dtype,out_dtype", [
    (752, 1024, 4096, True, torch.bfloat16, torch.bfloat16),  # v3 fc1 on 4 x 188 frames
    (752, 4096, 1024, True, torch.bfloat16, torch.bfloat16),  # v3 fc2
    (375, 1024, 1024, False, torch.bfloat16, torch.bfloat16),  # v3 pos, 2T-1 rows, no bias
    (37, 128, 130, False, torch.float32, torch.float32),  # tests/test_quant_pallas.py
    (100, 256, 192, True, torch.float32, torch.float32),
    (65, 48, 129, True, torch.bfloat16, torch.float32),  # K tail in its tile, odd N
    (1, 16, 1, True, torch.float32, torch.bfloat16),
    (300, 64, 1024, True, torch.bfloat16, torch.bfloat16),  # the test-tiny fixture's K
    (24064, 4096, 1024, True, torch.bfloat16, torch.bfloat16),  # v3 fc2 at B=128: many tiles
    (24065, 4096, 1024, True, torch.bfloat16, torch.bfloat16),  # last M tile holds one row
    (8, i8.MAX_K, 40, False, torch.float32, torch.float32),  # the largest K: 1,041 K steps
])
def test_int8_kernel_matches_plain_bit_for_bit(cuda, M, K, N, with_bias, x_dtype, out_dtype):
    """The kernel rounds where the plain version does (IEEE quotient, half
    to even, exact int32 sum, separate products and sum), so the outputs
    are equal, bit for bit."""
    x, wq, ws, bias = _int8_inputs(M, K, N, with_bias, x_dtype, cuda)
    before = i8.int8_matmul_fused.launches
    got = i8.int8_matmul_fused(x, wq, ws, bias, out_dtype)
    torch.cuda.synchronize()
    assert i8.int8_matmul_fused.launches == before + 1
    want = i8.int8_matmul_fused_plain(x, wq, ws, bias, out_dtype)
    assert got.dtype == out_dtype and got.shape == (M, N)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["k_not_16", "float16", "noncontiguous", "misaligned",
                                 "f64_scale", "k_past_int32_sum"])
def test_int8_wrapper_rejects_what_the_kernel_does_not_take(cuda, bad):
    K = {"k_not_16": 40, "k_past_int32_sum": i8.MAX_K + 16}.get(bad, 32)
    M, N = 8, 16
    x, wq, ws, bias = _int8_inputs(M, K, N, True, torch.float32, cuda)
    if bad == "float16":
        x = x.half()
    elif bad == "noncontiguous":
        x = torch.randn(K, M, device=cuda).T
    elif bad == "misaligned":
        x = torch.zeros(M * K + 1, device=cuda)[1:].view(M, K)
    elif bad == "f64_scale":
        ws = ws.double()
    with pytest.raises(ValueError):
        i8.int8_matmul_fused(x, wq, ws, bias)


def test_int8_trained_fixture_launches_per_layer_and_matches_cpu(cuda):
    """The trained test-tiny model with quantization="int8" on the card: 23
    int8 launches per encoder call (11 per block x 2 + the subsampling
    projection), the encoder within relative L2 1e-2 of the CPU run and the
    CPU's transcript. The mel and f32 convolutions sum in another order on
    the card, which can flip an int8 code at a .5 boundary; the trained
    64-wide fixture carries such a flip through both blocks (2.5e-3 seen on
    an H100, as between JAX op by op and jitted on the CPU)."""
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.zoo import AsrModels
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    load = lambda dev: AsrModels.load("test-tiny", checkpoint_dir=TRAINED_ASR, device=dev,
                                      allow_random_init=False, quantization="int8")
    on_card, on_cpu = load(cuda), load("cpu")
    rs = np.random.RandomState(12345)
    ids = rs.randint(0, tc.N_WORDS, size=5)
    audio = tc.make_utterance(ids, rs)
    x = torch.from_numpy(audio)[None]
    n = torch.tensor([audio.size], dtype=torch.int32)
    enc_c, _ = on_cpu.encoder(*on_cpu.mel(x, n))
    before = i8.int8_matmul_fused.launches
    enc_g, _ = on_card.encoder(*on_card.mel(x.to(cuda), n.to(cuda)))
    torch.cuda.synchronize()
    assert i8.int8_matmul_fused.launches - before == 11 * 2 + 1
    rel = (torch.linalg.vector_norm(enc_g.cpu() - enc_c) / torch.linalg.vector_norm(enc_c))
    assert float(rel) <= 1e-2
    text = AsrManager(on_card).transcribe(audio).text
    assert text == AsrManager(on_cpu).transcribe(audio).text


def test_int8_linear_on_the_card_launches_once_per_call(cuda):
    layer = quant.Int8Linear(64, 48, out_dtype=torch.bfloat16)
    state = quant.quantize_linear_state({"weight": torch.randn(48, 64) * 0.1,
                                         "bias": torch.randn(48)})
    layer.load_state_dict({k: v for k, v in state.items()})
    layer = layer.to(cuda, torch.bfloat16)
    assert layer.weight_scale.dtype == torch.float32 and layer.bias.dtype == torch.float32
    x = torch.randn(3, 7, 64, device=cuda).bfloat16()
    before = i8.int8_matmul_fused.launches
    got = layer(x)
    torch.cuda.synchronize()
    assert i8.int8_matmul_fused.launches == before + 1 and got.shape == (3, 7, 48)
    want = i8.int8_matmul_fused_plain(x.reshape(-1, 64), layer.weight_q, layer.weight_scale,
                                      layer.bias, torch.bfloat16).reshape(3, 7, 48)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ------------------------------------------------------------ streaming ASR

TRAINED = TRAINED_ASR.parent


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_streaming_chunk_step_matches_cpu(cuda, dtype, tol):
    """The cache-aware encoder's chunk step on the card against the CPU on
    the same weights and mel, 3 carried chunks at 2 streams: relative L2 of
    the output and every cache field (true f32: 1e-4; bf16 rounds each
    matmul and LayerNorm output to 8 bits, at other points on each side)."""
    import copy

    from fluidaudio_tpu_torch.models import conformer_streaming as cs
    from fluidaudio_tpu_torch.models.zoo import random_init_

    cfg = cs.StreamingConformerConfig(d_model=256, n_layers=3, n_heads=2,
                                      subsampling_channels=64, dtype=dtype)
    cpu_enc = cs.StreamingConformerEncoder(cfg).eval()
    random_init_(cpu_enc, torch.Generator().manual_seed(0))
    card_enc = copy.deepcopy(cpu_enc).to(cuda)
    rs = np.random.RandomState(0)
    card_c, cpu_c = cs.init_caches(cfg, 2, cuda), cs.init_caches(cfg, 2, "cpu")
    for T in (56, 56, 16):
        mel = torch.from_numpy(rs.randn(2, 128, T).astype(np.float32))
        got, card_c = card_enc(mel.to(cuda), card_c)
        want, cpu_c = cpu_enc(mel, cpu_c)
        for g, w in [(got, want), *((getattr(card_c, f), getattr(cpu_c, f))
                                    for f in ("pre_cache", "channel", "time"))]:
            g, w = g.float().cpu(), w.float()
            assert float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)) <= tol
        assert torch.equal(card_c.channel_len.cpu(), cpu_c.channel_len)


def _streaming_fixture_managers(device):
    from fluidaudio_tpu_torch.asr import streaming_eou as se
    from fluidaudio_tpu_torch.asr import streaming_nemotron as sn

    eou = se.StreamingEouAsrManager(chunk_ms=320, spec=se.EOU_TEST,
                                    checkpoint_dir=TRAINED / "eou", device=device)
    nem = sn.StreamingNemotronAsrManager(sn.NEMOTRON_TEST, 560, enc_cfg=se.EOU_TEST.enc_cfg,
                                         checkpoint_dir=TRAINED / "nemotron", device=device)
    return eou, nem


def test_streaming_fixtures_on_card_match_cpu(cuda):
    """The trained EOU and Nemotron managers on the card give the CPU's
    tokens and timestamps and the known transcripts; a 3-stream session on
    the card gives each stream's single-stream result."""
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    on_card, on_cpu = _streaming_fixture_managers(cuda), _streaming_fixture_managers("cpu")
    rs = np.random.RandomState(2468)
    tail = np.zeros(20_480, np.float32)
    utts, refs = [], []
    for lang in ("a", "b", "a"):
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 8)))
        utts.append(np.concatenate([tc.make_utterance(ids, rs, lang=lang), tail]))
        refs.append(" ".join(tc.word_text(i) if lang == "a" else tc.word_text_b(i) for i in ids))
    for k, (card, cpu) in enumerate(zip(on_card, on_cpu)):
        finals = []
        for i, a in enumerate(utts):
            if k == 0 and i == 1:
                continue  # the EOU fixture knows language a only
            if k == 1:
                card.set_language("bb-BB" if i == 1 else "aa-AA")
                cpu.set_language("bb-BB" if i == 1 else "aa-AA")
            got, want = card.make_state(), cpu.make_state()
            card.process(a, got)
            cpu.process(a, want)
            f, w = card.finish(got), cpu.finish(want)
            assert f.token_ids == w.token_ids and f.timestamps_ms == w.timestamps_ms
            assert f.text == refs[i]
            finals.append(f)
        if k == 0:
            session = card.make_multi_state(2)
            card.process_multi(session, [utts[0], utts[2]])
            multi = card.flush_multi(session)
            assert [m.token_ids for m in multi] == [f.token_ids for f in finals]
            assert [m.timestamps_ms for m in multi] == [f.timestamps_ms for f in finals]


# head widths of the attention dispatch: outside the kernel's range (Cohere's
# trained fixture, Dh 8; its full width, Dh 160) and inside it (v3, Dh 128)
MHSA_WIDTHS = [("dh8", 32, 4, 0), ("dh160", 1280, 8, 0), ("dh128", 1024, 8, 1)]


@pytest.mark.parametrize("name,d_model,n_heads,launches", MHSA_WIDTHS,
                         ids=[w[0] for w in MHSA_WIDTHS])
def test_mhsa_dispatch_on_the_card_matches_cpu(cuda, name, d_model, n_heads, launches):
    """f32 `RelPosMHSA` on the card against the CPU within 1e-4 on valid
    rows: outside the kernel's head widths it runs the plain version on the
    card (0 launches, 1 plain call); at Dh 128 it launches the kernel once."""
    import copy

    from fluidaudio_tpu_torch.models import conformer as cf
    from fluidaudio_tpu_torch.models.zoo import random_init_

    cpu_mhsa = cf.RelPosMHSA(cf.ConformerConfig(d_model=d_model, n_heads=n_heads,
                                                dtype="float32")).eval()
    random_init_(cpu_mhsa, torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu_mhsa.pos_bias_u.normal_(0, 0.1, generator=torch.Generator().manual_seed(1))
    card_mhsa = copy.deepcopy(cpu_mhsa).to(cuda)
    B, T = 2, 47
    x = torch.randn(B, T, d_model, generator=torch.Generator().manual_seed(2))
    lengths = torch.tensor([T, 30], dtype=torch.int32)
    pos = cf.rel_sinusoid(T, d_model)
    want = cpu_mhsa(x, pos, lengths)
    a0, p0 = attn.relpos_attention.launches, attn.relpos_attention_plain.calls
    with torch.no_grad():
        got = card_mhsa(x.to(cuda), pos.to(cuda), lengths.to(cuda))
    torch.cuda.synchronize()
    assert attn.relpos_attention.launches - a0 == launches
    assert attn.relpos_attention_plain.calls - p0 == 1 - launches
    for b, n in enumerate(lengths.tolist()):
        torch.testing.assert_close(got[b, :n].cpu(), want[b, :n].detach(), rtol=1e-4, atol=1e-4)


def test_ctc_greedy_decode_on_the_card_matches_cpu(cuda):
    """The device-side collapse and left-pack (a stable sort of an int32 key)
    equal the CPU's tokens, frames and counts, padding included."""
    from fluidaudio_tpu_torch.ops.ctc_decode import ctc_greedy_decode

    g = torch.Generator().manual_seed(3)
    B, T, V = 6, 188, 1025
    logits = torch.randn(B, T, V, generator=g)
    best = torch.randint(0, V, (B, T), generator=g)
    best[:, 1::2] = best[:, 0::2]  # repeats
    best[-1] = V - 1  # an all-blank row
    logits.scatter_(2, best[..., None], 9.0)
    lp = torch.log_softmax(logits, dim=-1)
    lengths = torch.tensor([T, 100, 0, 1, 57, T], dtype=torch.int32)
    want = ctc_greedy_decode(lp, lengths, V - 1)
    got = ctc_greedy_decode(lp.to(cuda), lengths.to(cuda), V - 1)
    for g_, w in zip(got, want):
        assert g_.device.type == "cuda" and g_.dtype == torch.int32
        assert torch.equal(g_.cpu(), w)


def test_keyword_spotter_two_chunks_on_the_card_matches_cpu(cuda):
    """The trained `ctc` fixture spotter (Dh 16: the attention kernel) on a
    17 s utterance, two chunks and a seam: the card's canvas within 1e-4 of
    the CPU's, 2 layers x 2 chunks of kernel launches, the same spots."""
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    terms = ["w0 w3", "w5", "w1 w2 w6"]
    card, _ = fx._ctc_spotter(terms, device=cuda)
    cpu, _ = fx._ctc_spotter(terms, device="cpu")
    rs = np.random.RandomState(2024)
    seq = list(rs.randint(8, tc.N_WORDS, size=34))
    for pos, ids in ((3, [0, 3]), (17, [5]), (30, [1, 2, 6])):
        seq[pos:pos] = ids
    audio = tc.make_utterance(np.asarray(seq), rs)
    a0 = attn.relpos_attention.launches
    got = card.log_probs(audio)
    assert attn.relpos_attention.launches - a0 == 2 * 2
    want = cpu.log_probs(audio)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    card_spots, cpu_spots = card.spot(audio), cpu.spot(audio)
    assert len(card_spots) == len(cpu_spots) >= 3
    for c, w in zip(card_spots, cpu_spots):
        assert (c.keyword, c.start_frame, c.end_frame) == (w.keyword, w.start_frame, w.end_frame)
        assert c.score == pytest.approx(w.score, abs=1e-4)


TRAINED = TRAINED_ASR.parent


def _family_texts(make, seed, max_words, device):
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    mgr = make(device)
    rs = np.random.RandomState(seed)
    texts = []
    for _ in range(4):
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, max_words)))
        texts.append(mgr.transcribe(tc.make_utterance(ids, rs)).text)
    return texts


@pytest.mark.parametrize("family", ["sensevoice", "paraformer", "cohere"])
def test_family_fixture_on_the_card_matches_cpu(cuda, family):
    """The trained SenseVoice, Paraformer and Cohere fixtures: the same texts
    on the card as on the CPU, and no kernel launched (Cohere's Dh-8 encoder
    takes the plain attention, one call per layer and window)."""
    from fluidaudio_tpu_torch.asr.cohere_manager import CoherePipeline
    from fluidaudio_tpu_torch.asr.paraformer_manager import ParaformerManager
    from fluidaudio_tpu_torch.asr.sensevoice_manager import SenseVoiceManager
    from fluidaudio_tpu_torch.models.paraformer import PARAFORMER_TEST
    from fluidaudio_tpu_torch.models.sensevoice import SENSEVOICE_TEST
    from fluidaudio_tpu_torch.train.fixtures import cohere_tiny_config

    make, seed, words = {
        "sensevoice": (lambda d: SenseVoiceManager(
            SENSEVOICE_TEST, checkpoint_dir=TRAINED / "sensevoice", device=d), 321, 9),
        "paraformer": (lambda d: ParaformerManager(
            PARAFORMER_TEST, checkpoint_dir=TRAINED / "paraformer", device=d), 654, 9),
        "cohere": (lambda d: CoherePipeline(
            cohere_tiny_config(), checkpoint_dir=TRAINED / "cohere", device=d), 987, 8),
    }[family]
    before = attn.relpos_attention.launches
    plain = attn.relpos_attention_plain.calls
    got = _family_texts(make, seed, words, cuda)
    torch.cuda.synchronize()
    assert attn.relpos_attention.launches == before
    assert (attn.relpos_attention_plain.calls - plain == 2 * 4) == (family == "cohere")
    assert got == _family_texts(make, seed, words, "cpu") and all(got)


def test_vad_fixture_on_the_card_matches_cpu(cuda):
    """The trained Silero: chunk probabilities within 1e-5 of the CPU's
    through `process_batch` (a CUDA graph per shape) and `process_chunk`,
    and the same final state."""
    from fluidaudio_tpu_torch.train.fixtures import vad_fixture_clips
    from fluidaudio_tpu_torch.vad import VadManager

    clips = [c for _, c in vad_fixture_clips()]
    card = VadManager(checkpoint_dir=TRAINED / "vad", device=cuda)
    cpu = VadManager(checkpoint_dir=TRAINED / "vad", device="cpu")
    for _ in range(2):  # the second call replays the captured graphs
        for got, want in zip(card.process_batch(clips), cpu.process_batch(clips)):
            np.testing.assert_allclose([r.probability for r in got],
                                       [r.probability for r in want], atol=1e-5)
            np.testing.assert_allclose(got[-1].output_state.hidden_state,
                                       want[-1].output_state.hidden_state, atol=1e-5)
    a, b = card.process_chunk(clips[0][:4096]), cpu.process_chunk(clips[0][:4096])
    assert abs(a.probability - b.probability) <= 1e-5


def test_vad_graphs_share_one_pool_and_stay_bounded(cuda):
    """More (batch, bucket) shapes than the program cache holds: every
    graph is captured in the manager's one pool after a warm-up on its one
    side stream, at most
    `PROGRAM_CACHE_SIZE` are kept, and every shape, an evicted one run
    again included, matches the CPU within 1e-5."""
    from fluidaudio_tpu_torch.train.fixtures import vad_fixture_clips
    from fluidaudio_tpu_torch.vad import VadManager
    from fluidaudio_tpu_torch.vad.manager import PROGRAM_CACHE_SIZE

    clips = [c for _, c in vad_fixture_clips()]
    card = VadManager(checkpoint_dir=TRAINED / "vad", device=cuda)
    cpu = VadManager(checkpoint_dir=TRAINED / "vad", device="cpu")
    shapes = [clips[: b % len(clips) + 1] for b in range(PROGRAM_CACHE_SIZE + 2)]
    shapes = [[c[: 4096 << (b % 3)] for c in rows] for b, rows in enumerate(shapes)]
    for rows in shapes + shapes[:1]:
        for got, want in zip(card.process_batch(rows), cpu.process_batch(rows)):
            np.testing.assert_allclose([r.probability for r in got],
                                       [r.probability for r in want], atol=1e-5)
    programs = list(card._program_cache.values())
    assert len(programs) <= PROGRAM_CACHE_SIZE
    assert all(p.pool is card._graph_pool and p.stream is card._warmup_stream
               and p.graph is not None for p in programs)


def test_cohere_decode_on_the_card_syncs_once_per_8_steps(cuda):
    """Random COHERE_TEST weights: the card's greedy decode equals the CPU's
    token for token, and reads its stopping rule at most once per 8 steps."""
    from fluidaudio_tpu_torch.models import cohere_asr as co
    from fluidaudio_tpu_torch.models.zoo import random_init_

    cfg = co.COHERE_TEST
    card = co.CohereDecoderStep(cfg, device=cuda).eval()
    random_init_(card, torch.Generator(device=cuda).manual_seed(0))
    cpu = co.CohereDecoderStep(cfg).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    enc = torch.randn(2, 9, cfg.enc_hidden, generator=torch.Generator().manual_seed(1))
    mask = torch.arange(9)[None, :] < torch.tensor([[9], [4]])
    out = [co.cohere_greedy_decode(cfg, dec, enc.to(dev), mask.to(dev))
           for dec, dev in ((card, cuda), (cpu, "cpu"))]
    assert torch.equal(out[0].tokens.cpu(), out[1].tokens)
    assert torch.equal(out[0].counts.cpu(), out[1].counts)
    assert out[0].host_syncs <= out[0].steps // 8 + 1


# ------------------------------------------------------------ converted checkpoints


def test_converted_nemo_checkpoint_on_the_card_matches_the_oracle(cuda, tmp_path):
    """A seeded test-tiny NeMo checkpoint (`chip_smoke.nemo_checkpoint`, raw
    ckpt) through the port's `convert_nemo_file`, loaded on the card with
    every key required: its f32 encoder launches the kernel once per layer
    and matches the NeMo oracle on the CPU on the raw weights (relative L2
    over valid frames within 1e-4, TF32 off)."""
    from dataclasses import replace

    from chip_smoke import nemo_checkpoint, valid_rel_l2
    from fluidaudio_tpu_torch.convert.parakeet import convert_nemo_file
    from fluidaudio_tpu_torch.models.zoo import ASR_VERSIONS, AsrModels

    spec = ASR_VERSIONS["test-tiny"]
    oracle, sd = nemo_checkpoint(replace(spec.conformer, dtype="float32"), spec.predictor, 3,
                                 "cpu")
    torch.save(sd, tmp_path / "model.ckpt")
    convert_nemo_file(tmp_path / "model.ckpt", tmp_path / "out", spec.conformer, spec.predictor)
    models = AsrModels.load("test-tiny", checkpoint_dir=tmp_path / "out", device=cuda,
                            allow_random_init=False, dtype="float32")
    mel = torch.randn(2, spec.conformer.n_mels, 160, generator=torch.Generator().manual_seed(4))
    mel[1, :, 100:] = 0.0
    lengths = torch.tensor([160, 100], dtype=torch.int32)
    before = attn.relpos_attention.launches
    got, got_len = models.encoder(mel.to(cuda), lengths.to(cuda))
    torch.cuda.synchronize()
    assert attn.relpos_attention.launches - before == spec.conformer.n_layers
    with torch.no_grad():
        want, want_len = oracle(mel, lengths.long())
    assert got_len.tolist() == want_len.tolist()
    assert valid_rel_l2(got.cpu(), want, want_len.tolist()) <= 1e-4


# ------------------------------------------------------- training and meshes

TRAIN_SMALL = dict(n_mels=16, d_model=256, n_layers=2, n_heads=2, subsampling_channels=16,
                   dtype="float32")


def test_auto_attention_at_dh128_refuses_a_gradient_on_the_card(cuda):
    """JAX's `jax.grad` cannot differentiate its Pallas kernel (Dh 128 on the
    TPU) and the port's kernel has no backward: `"auto"` under a gradient at
    Dh 128 on the card raises, naming `attention_backend="xla"`; serving
    (no gradient) still takes the kernel."""
    from fluidaudio_tpu_torch.models.conformer import ConformerConfig, ConformerEncoder

    enc = ConformerEncoder(ConformerConfig(**TRAIN_SMALL), device=cuda)
    mel = torch.randn(2, 16, 65, device=cuda)
    lengths = torch.tensor([65, 40], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match='attention_backend="xla"'):
        enc(mel, lengths)
    before = attn.relpos_attention.launches
    with torch.no_grad():
        enc(mel, lengths)
    assert attn.relpos_attention.launches == before + TRAIN_SMALL["n_layers"]


@pytest.mark.parametrize("kind", ["ctc", "tdt"])
def test_train_step_on_the_card_matches_cpu(cuda, kind):
    """The same parameters and batch on both devices, TF32 off: loss within
    1e-5 relative, the whole gradient within 1e-4 relative L2 (cuDNN's and
    cuBLAS's f32 orders); no launch of either kernel."""
    from fluidaudio_tpu_torch.models.conformer import ConformerConfig
    from fluidaudio_tpu_torch.models.predictor import PredictorConfig
    from fluidaudio_tpu_torch.models.zoo import disable_tf32
    from fluidaudio_tpu_torch.parallel import train as pt

    disable_tf32()
    cfg = ConformerConfig(**TRAIN_SMALL, attention_backend="xla")
    pcfg = PredictorConfig(vocab_size=32, pred_hidden=32, n_layers=1, enc_hidden=256,
                           joint_hidden=32, n_durations=5)
    rs = np.random.RandomState(0)
    batch = {"mel": rs.randn(2, 16, 65).astype(np.float32),
             "mel_lengths": np.array([65, 41], np.int32),
             "labels": rs.randint(0, 32, (2, 8)).astype(np.int32),
             "label_lengths": np.array([8, 5], np.int32)}
    out = {}
    for device in ("cpu", cuda):
        gen = torch.Generator(device="cpu").manual_seed(0)
        if kind == "ctc":
            state, enc, _ = pt.create_train_state(gen, cfg, 32, 65, device="cpu")
            objective = pt.CtcObjective(enc.to(device), 32)
        else:
            state, mods, _ = pt.create_tdt_train_state(gen, cfg, pcfg, 65, device="cpu")
            objective = pt.TdtObjective(tuple(m.to(device) for m in mods), pcfg, (0, 1, 2, 3, 4))
        params = {k: v.detach().to(device).requires_grad_(True) for k, v in state.params.items()}
        before = (attn.relpos_attention.launches, i8.int8_matmul_fused.launches)
        loss, grads = pt.loss_and_grads(objective, params, batch)
        assert (attn.relpos_attention.launches, i8.int8_matmul_fused.launches) == before
        out[str(device)] = (float(loss), {k: g.cpu() for k, g in grads.items()})
    (cpu_loss, cpu_g), (card_loss, card_g) = out["cpu"], out[str(cuda)]
    assert abs(card_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    err = sum(float((card_g[k] - g).norm()) ** 2 for k, g in cpu_g.items()) ** 0.5
    assert err <= 1e-4 * sum(float(g.norm()) ** 2 for g in cpu_g.values()) ** 0.5


def test_one_card_mesh_serves_as_unsharded(cuda):
    """`make_mesh(1)` brings up a one-rank NCCL group; `jit_sharded_infer`
    on it gives the unsharded decode's tokens on the trained test-tiny
    fixture, through the kernel (Dh 16)."""
    import torch.distributed as dist

    from fluidaudio_tpu_torch.models.zoo import AsrModels
    from fluidaudio_tpu_torch.ops.tdt_decode import TdtDecodeConfig, make_initial_state
    from fluidaudio_tpu_torch.ops.tdt_decode import tdt_greedy_decode
    from fluidaudio_tpu_torch.parallel.infer import jit_sharded_infer
    from fluidaudio_tpu_torch.parallel.mesh import make_mesh

    owned = not dist.is_initialized()
    mesh = make_mesh(1, device=cuda)
    try:
        m = AsrModels.load("test-tiny", checkpoint_dir=TRAINED_ASR, allow_random_init=False,
                           device=cuda)
        params = {f"{n}.{k}": v for n, part in (("encoder", m.encoder),
                                                ("predictor", m.predictor),
                                                ("joint", m.joint))
                  for k, v in part.named_parameters()}
        audio = torch.randn(2, 48_000, device=cuda) * 0.1
        mel, mel_len = m.mel(audio, torch.tensor([48_000, 30_000], dtype=torch.int32,
                                                 device=cuda))
        before = attn.relpos_attention.launches
        tokens, counts, enc_len = jit_sharded_infer(
            mesh, (m.encoder, m.predictor, m.joint), m.spec.predictor, params)(params, mel,
                                                                              mel_len)
        assert attn.relpos_attention.launches == before + m.spec.conformer.n_layers
        with torch.no_grad():
            enc, enc_len2 = m.encoder(mel, mel_len)
            dcfg = TdtDecodeConfig(blank_id=m.blank_id, max_tokens=64)
            ref = tdt_greedy_decode(dcfg, m.predictor, m.joint, enc, enc_len2,
                                    make_initial_state(dcfg, 1, m.spec.predictor.pred_hidden, 2,
                                                       device=cuda))
        assert torch.equal(tokens, ref.tokens) and torch.equal(counts, ref.counts)
    finally:
        if owned:
            dist.destroy_process_group()


# ------------------------------------------- the Sortformer head's attention

SA_TOL = 1e-5  # f32 on both sides: summation order and exp2 against exp


def _sa_inputs(B, N, H, Dh, device, seed=0, mask=None, fused=False):
    """`chip_smoke.self_attention_inputs`: q, k, v and the [B, N] validity."""
    from chip_smoke import self_attention_inputs

    return self_attention_inputs(B, N, H, Dh, device, seed=seed, mask=mask, fused=fused)


@pytest.mark.parametrize("B,N,H,Dh,mask", [
    (16, 384, 8, 24, None),  # the offline windows, the smallest bucket
    (128, 384, 8, 24, None),  # the largest bucket
    (1, 234, 8, 24, "stream"),  # the chunk step: 188 + 40 + 6
    (3, 46, 4, 8, "random"),  # the trained fixture's widths (d 32, H 4)
    (2, 100, 2, 16, "random"),
    (2, 70, 2, 32, None),
    (2, 65, 3, 40, "random"),
    (2, 129, 2, 64, "random"),
])
def test_self_attention_kernel_matches_plain(cuda, B, N, H, Dh, mask):
    from fluidaudio_tpu_torch.ops import self_attention as sa

    q, k, v, valid = _sa_inputs(B, N, H, Dh, cuda, seed=N, mask=mask)
    before = sa.self_attention.launches
    got = sa.self_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert sa.self_attention.launches == before + 1
    assert got.is_contiguous() and got.dtype == torch.float32 and got.shape == (B, N, H, Dh)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, sa.self_attention_plain(q, k, v, valid), atol=SA_TOL,
                               rtol=0)
    if mask == "stream":  # the masked queries take the mean of v over all N
        masked = ~valid[0]
        torch.testing.assert_close(got[0, masked], v[0].mean(0).expand_as(got[0, masked]),
                                   atol=SA_TOL, rtol=0)


@pytest.mark.parametrize("B,N,H,Dh", [(4, 384, 8, 24), (3, 46, 4, 8)])
def test_self_attention_on_projection_views(cuda, B, N, H, Dh):
    """Strided views of one fused [B, N, 3 H Dh] projection, as the reshaped
    Linear outputs are views: the same result as on contiguous copies."""
    from fluidaudio_tpu_torch.ops import self_attention as sa

    q, k, v, _ = _sa_inputs(B, N, H, Dh, cuda, seed=1, fused=True)
    assert not q.is_contiguous()
    got = sa.self_attention(q, k, v)
    torch.testing.assert_close(got, sa.self_attention_plain(q, k, v), atol=SA_TOL, rtol=0)
    torch.testing.assert_close(got, sa.self_attention(*(x.contiguous() for x in (q, k, v))),
                               atol=0, rtol=0)


@pytest.mark.parametrize("bad", ["float64", "bfloat16", "dh12", "dh72", "misaligned",
                                 "valid_on_cpu"])
def test_self_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda, bad):
    from fluidaudio_tpu_torch.ops import self_attention as sa

    q, k, v, _ = _sa_inputs(2, 16, 4, 24, cuda)
    valid = None
    if bad in ("float64", "bfloat16"):
        q, k, v = (x.to(getattr(torch, bad)) for x in (q, k, v))
    elif bad in ("dh12", "dh72"):
        q = k = v = torch.randn(2, 16, 2, int(bad[2:]), device=cuda)
    elif bad == "misaligned":  # rows of 98 floats
        q = torch.randn(2, 16, 98, device=cuda)[..., :96].reshape(2, 16, 4, 24)
    elif bad == "valid_on_cpu":
        valid = torch.ones(2, 16, dtype=torch.bool)
    before = sa.self_attention.launches
    with pytest.raises(ValueError):
        sa.self_attention(q, k, v, valid)
    assert sa.self_attention.launches == before


def _head_model(cuda, seed=0):
    from fluidaudio_tpu_torch.models.sortformer import SORTFORMER_V2, SortformerModel
    from fluidaudio_tpu_torch.models.zoo import random_init_

    model = SortformerModel(SORTFORMER_V2, device=cuda).eval()
    random_init_(model, torch.Generator(device=cuda).manual_seed(seed))
    return model


def test_sortformer_v2_forward_kernel_against_plain(cuda, monkeypatch):
    """`SortformerModel.forward` at SORTFORMER_V2 width on two offline
    windows: 18 launches, one per head layer, and the plain head's
    predictions within SA_TOL; the head allocates no [B, 8, N, N] scores."""
    from fluidaudio_tpu_torch.models import sortformer as msf
    from fluidaudio_tpu_torch.ops import self_attention as sa

    model = _head_model(cuda)
    mel = torch.randn(2, 128, 3072, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = sa.self_attention.launches
    got = model(mel)
    torch.cuda.synchronize()
    assert sa.self_attention.launches == before + 18
    ctx = model.encode_frames(mel)
    B, N, _ = ctx.shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model.predict(ctx)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < B * 8 * N * N * 4
    monkeypatch.setattr(msf, "kernel_takes_head_dim", lambda hd: False)  # the plain head
    before = sa.self_attention.launches
    want = model(mel)
    assert sa.self_attention.launches == before
    torch.testing.assert_close(got, want, atol=SA_TOL, rtol=0)


def test_sortformer_v2_step_graph_against_eager(cuda):
    """The chunk step at SORTFORMER_V2 width: 18 launches per eager step
    (the [B, N] context mask); the `StepProgram` CUDA graph's replays give
    the eager steps' predictions and state."""
    from fluidaudio_tpu_torch.models import sortformer as msf
    from fluidaudio_tpu_torch.ops import self_attention as sa

    model = _head_model(cuda, seed=2)
    cfg = model.cfg
    frames = torch.randn(12, cfg.chunk_frames, cfg.d_model,
                         generator=torch.Generator().manual_seed(3)).to(cuda)
    state = msf.init_state(cfg, 1, device=cuda)
    before = sa.self_attention.launches
    eager, s_eager = [], state
    for i in range(frames.shape[0]):
        p, s_eager = msf.streaming_step_from_frames(model, frames[i:i + 1], s_eager, cfg)
        eager.append(p[0])
    torch.cuda.synchronize()
    assert sa.self_attention.launches == before + 18 * frames.shape[0]
    program = msf.StepProgram(model, cfg)
    got, s_graph = program.scan(frames, state, frames.shape[0])
    assert program.graph is not None
    torch.testing.assert_close(got, torch.stack(eager), atol=SA_TOL, rtol=0)
    for g, w in zip(s_graph, s_eager):
        if g.dtype == torch.bool or not g.is_floating_point():
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, atol=SA_TOL, rtol=0)
