"""The port's CUDA kernel and its on-card path (needs an NVIDIA GPU).

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
                                 "misaligned"])
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda, bad):
    B, H, T, Dh = 2, 2, 8, 144 if bad == "dh144" else (8 if bad == "dh8" else 32)
    dtype = torch.float16 if bad == "float16" else torch.float32
    qu, qw, k, v, p = _inputs(B, H, T, Dh, dtype, cuda)
    lens = torch.full((B,), T, dtype=torch.int64 if bad == "int64_lengths" else torch.int32,
                      device=cuda)
    if bad == "noncontiguous":
        k = torch.randn(B, T, H, Dh, device=cuda).transpose(1, 2)
    elif bad == "misaligned":  # bf16 rows are read as 16-byte vectors
        flat = torch.zeros(B * H * T * Dh + 1, dtype=torch.bfloat16, device=cuda)
        qu, qw, k, v = (x.bfloat16() for x in (qu, qw, k, v))
        p = p.bfloat16()
        k = flat[1:].view(B, H, T, Dh)
    with pytest.raises(ValueError):
        attn.relpos_attention(qu, qw, k, v, p, lens, T)


def test_trained_fixture_encoder_and_transcript_match_cpu(cuda):
    """The trained test-tiny model (f32, Dh 16) on the card: every encoder
    layer launches the kernel, the encoder output matches the CPU run, and
    the transcript is the CPU's."""
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.zoo import AsrModels
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    on_card = AsrModels.load("test-tiny", checkpoint_dir=TRAINED_ASR, device=cuda,
                             allow_random_init=False)
    on_cpu = AsrModels.load("test-tiny", checkpoint_dir=TRAINED_ASR, allow_random_init=False)
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
