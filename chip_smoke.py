#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`fluidaudio_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernel is built for sm_90a) and `nvcc`;
there is no CPU fallback. It imports nothing of JAX or of the JAX package.
Phases, one line each; any failure raises and the final line is not printed:

  1. device: the card's name and power limit (nvidia-smi), and the time to
     build the rel-pos attention kernel from `fluidaudio_tpu_torch/csrc/`;
  2. the kernel against its plain PyTorch version on the card at the v3
     shapes (B=4, H=8, T=188, Dh=128, lengths [188,100,17,188], bf16; max abs
     error on valid rows below 0.06) and on the shift-only probe;
  3. the trained `test-tiny` fixture on the card (f32, through the kernel):
     5- and 40-word utterances at WER <= 0.02, and the same text as the port
     on the CPU;
  4. Parakeet TDT v3 at full width (24 x 1024, 8 heads, vocab 8192) with
     seeded random weights: 5 s, 15 s and ~40 s chunked requests through
     `AsrManager.transcribe` (parallel_chunk_batch=4); the attention kernel
     must launch 24 times per encoder call; then the kernel encoder against
     the plain-attention encoder on one 15 s batch;
  5. timing: the kernel against the plain version at B=128, the v3 encoder
     at B=128 with each, and the v3 `build_pipeline(128)` RTFx on 15 s
     windows with the joint blank bias calibrated to 9-12 tokens/s of audio.

The line before the last is the kernel record (JSON); the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
TRAINED_ASR = REPO / "fluidaudio_tpu" / "assets" / "trained_tiny" / "asr"
PARITY_TOL = 0.06  # bf16 inputs, f32 math on both sides (scripts/tpu_kernel_parity.py)
WER_GATE = 0.02
TARGET_TOK_PER_S = (9.0, 12.0)  # LibriSpeech-like emission band of v3
WINDOW = 240_000  # 15 s at 16 kHz


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def speechlike(rs: np.random.RandomState, seconds: float) -> np.ndarray:
    """Noise with a 4 Hz syllabic envelope, the input shape `bench.py` uses."""
    t = np.arange(int(seconds * 16_000)) / 16_000.0
    am = 0.5 * (1.0 + np.sin(2 * np.pi * 4.0 * t))
    return (rs.randn(t.size) * 0.1 * am).astype(np.float32)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of `fn` in ms over `iters` calls, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(B, H, T, Dh, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=device).to(dtype)
    return rnd(B, H, T, Dh), rnd(B, H, T, Dh), rnd(B, H, T, Dh), rnd(B, H, T, Dh), rnd(
        H, 2 * T - 1, Dh)


def valid_rows_err(a: torch.Tensor, b: torch.Tensor, lengths: list[int]) -> float:
    return max((a[i, :, :n] - b[i, :, :n]).abs().max().item() for i, n in enumerate(lengths))


# ---------------------------------------------------------------- phases


def phase_device(attn) -> tuple[str, float]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    build_s = attn.build_seconds()
    print(f"phase 1 device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| kernel build {build_s:.2f} s")
    return smi, build_s


def phase_kernel_parity(attn, device) -> float:
    lengths = [188, 100, 17, 188]
    qu, qw, k, v, p = attention_inputs(4, 8, 188, 128, torch.bfloat16, device, seed=0)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    got = attn.relpos_attention(qu, qw, k, v, p, lens, 188)
    torch.cuda.synchronize()
    want = attn.relpos_attention_plain(qu, qw, k, v, p, lens, 188)
    err = valid_rows_err(got, want, lengths)
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    check(err < PARITY_TOL, f"kernel vs plain max abs err {err} >= {PARITY_TOL}")

    # shift-only probe: q.k = 0, peaked position scores expose a wrong XL index
    g = torch.Generator(device=device).manual_seed(2)
    T = 24
    qw1 = (torch.randn(1, 1, T, 128, generator=g, device=device) * 2.0).to(torch.bfloat16)
    p1 = (torch.randn(1, 2 * T - 1, 128, generator=g, device=device) * 2.0).to(torch.bfloat16)
    v1 = torch.randn(1, 1, T, 128, generator=g, device=device).to(torch.bfloat16)
    z = torch.zeros_like(qw1)
    lens1 = torch.tensor([T], dtype=torch.int32, device=device)
    got1 = attn.relpos_attention(z, qw1, z, v1, p1, lens1, T)
    torch.cuda.synchronize()
    shift_err = (got1 - attn.relpos_attention_plain(z, qw1, z, v1, p1, lens1, T)).abs().max().item()
    check(shift_err < PARITY_TOL, f"shift-only probe err {shift_err}")
    print(f"phase 2 kernel vs plain: B=4 H=8 T=188 Dh=128 bf16 lengths {lengths} "
          f"max_abs_err(valid rows) {err:.3e} | shift-only probe {shift_err:.3e} "
          f"| tol {PARITY_TOL}")
    return err


def phase_trained_fixture(device) -> None:
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.metrics.wer import wer
    from fluidaudio_tpu_torch.models.zoo import AsrModels
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    def manager(dev):
        models = AsrModels.load("test-tiny", checkpoint_dir=TRAINED_ASR, device=dev,
                                allow_random_init=False)
        return AsrManager(models, ASRConfig(parallel_chunk_batch=2))

    on_card, on_cpu = manager(device), manager("cpu")
    rs = np.random.RandomState(12345)  # the draws of train/fixtures.eval_asr_fixture
    parts = []
    for n in (5, 40):
        ids = rs.randint(0, tc.N_WORDS, size=n)
        audio = tc.make_utterance(ids, rs)
        text = on_card.transcribe(audio).text
        rate = wer(tc.transcript_text(ids), text).rate
        check(rate <= WER_GATE, f"{n}-word WER {rate} > {WER_GATE}: {text!r}")
        check(text == on_cpu.transcribe(audio).text, f"{n}-word text differs from the CPU run")
        parts.append(f"{n} words WER {rate:.4f}")
    print(f"phase 3 trained test-tiny on card: {' | '.join(parts)} | same text as CPU")


def encoder_calls_for(manager, audio: np.ndarray) -> int:
    """Encoder calls `manager.transcribe(audio)` makes: one for a single
    window, one per group of `parallel_chunk_batch` windows when chunked."""
    from fluidaudio_tpu_torch.asr.chunk import ChunkProcessor
    from fluidaudio_tpu_torch.asr.constants import ASRConstants
    from fluidaudio_tpu_torch.utils.audio_source import ArrayAudioSource

    if audio.size <= ASRConstants.MAX_MODEL_SAMPLES:
        return 1
    cfg = manager.config
    _, windows = ChunkProcessor(ArrayAudioSource(audio)).plan_windows(
        mel_chunk_context=cfg.mel_chunk_context, model_version=manager.models.spec.name,
        prefer_silence_alignment=cfg.prefer_silence_alignment)
    return -(-len(windows) // cfg.parallel_chunk_batch)


def calibrate_blank_bias(pipeline, models, audio, lengths, seconds: float) -> float:
    """Bisect the joint's blank-logit bias until the decode emits 9-12 tokens
    per second of audio (higher bias, fewer emissions); sets it in place and
    returns the tokens/s reached."""
    bias = models.joint.out.bias
    blank = models.blank_id
    lo, hi = -12.0, 12.0
    tps = 0.0
    for _ in range(10):
        mid = 0.5 * (lo + hi)
        with torch.no_grad():
            bias[blank] = mid
        result, _ = pipeline(audio, lengths)
        tps = float(result.counts.sum().item()) / seconds
        if TARGET_TOK_PER_S[0] <= tps <= TARGET_TOK_PER_S[1]:
            break
        if tps > TARGET_TOK_PER_S[1]:
            lo = mid
        else:
            hi = mid
    return tps


def phase_v3_requests(attn, device, version: str = "v3"):
    """The main path: AsrModels.load -> AsrManager.transcribe at full width."""
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.zoo import AsrModels

    t0 = time.perf_counter()
    models = AsrModels.load(version, device=device, allow_random_init=True, rng_seed=0)
    manager = AsrManager(models, ASRConfig(parallel_chunk_batch=4))
    load_s = time.perf_counter() - t0
    n_layers = models.spec.conformer.n_layers
    vocab_out = models.spec.predictor.num_token_logits

    rs = np.random.RandomState(0)
    cal = np.stack([speechlike(rs, 15.0) for _ in range(16)])
    tps = calibrate_blank_bias(manager.build_pipeline(16), models, torch.from_numpy(cal),
                               torch.full((16,), WINDOW, dtype=torch.int32), 16 * 15.0)
    requests = [("5s", speechlike(rs, 5.0)), ("15s", speechlike(rs, 15.0)),
                ("40s chunked", speechlike(rs, 40.0))]

    torch.cuda.synchronize()
    attn.relpos_attention.launches = 0
    results = []
    for name, audio in requests:
        encoder_calls = encoder_calls_for(manager, audio)
        before = attn.relpos_attention.launches
        t0 = time.perf_counter()
        res = manager.transcribe(audio)
        wall = time.perf_counter() - t0
        launched = attn.relpos_attention.launches - before
        check(launched == n_layers * encoder_calls,
              f"{name}: {launched} attention launches, want {n_layers} x {encoder_calls}")
        ids = [t.token_id for t in res.token_timings]
        confs = [t.confidence for t in res.token_timings]
        check(all(0 <= i < vocab_out for i in ids), f"{name}: token id out of range")
        check(bool(np.isfinite(confs).all()) and bool(np.isfinite(res.confidence)),
              f"{name}: non-finite confidences")
        results.append(f"{name}: {len(ids)} tokens, {launched} launches, {wall:.3f} s")
    torch.cuda.synchronize()
    launches = attn.relpos_attention.launches
    check(launches > 0, "the main path never launched the attention kernel")

    # kernel encoder against the plain-attention encoder on one 15 s batch
    lengths = [WINDOW, 160_000, 80_000, WINDOW]
    audio = torch.from_numpy(np.stack([speechlike(rs, 15.0) for _ in lengths])).to(device)
    mel, mel_len = models.mel(audio, torch.tensor(lengths, dtype=torch.int32, device=device))
    enc_k, enc_len = models.encoder(mel, mel_len)
    enc_p, _ = models.encoder(mel, mel_len, attention=attn.relpos_attention_plain)
    check(bool(torch.isfinite(enc_k).all()), "v3 encoder output not finite")
    valid = [int(n) for n in enc_len.tolist()]
    max_abs = max((enc_k[i, :n] - enc_p[i, :n]).abs().max().item() for i, n in enumerate(valid))
    rel = (torch.linalg.vector_norm(enc_k - enc_p) / torch.linalg.vector_norm(enc_p)).item()
    check(rel < 0.05, f"kernel encoder vs plain encoder relative error {rel}")
    print(f"phase 4 {version} full width ({n_layers}x{models.spec.conformer.d_model}, "
          f"load {load_s:.1f} s, calibrated {tps:.2f} tok/s): {' | '.join(results)} | "
          f"main-path attention launches {launches} | encoder kernel vs plain on 15 s x4: "
          f"max_abs {max_abs:.3e} rel {rel:.3e} ({models.spec.conformer.dtype})")
    return models, manager, launches


def time_kernel(attn, device, smi: str, batch: int = 128) -> tuple[float, float]:
    qu, qw, k, v, p = attention_inputs(batch, 8, 188, 128, torch.bfloat16, device, seed=1)
    lens = torch.full((batch,), 188, dtype=torch.int32, device=device)
    kernel = lambda: attn.relpos_attention(qu, qw, k, v, p, lens, 188)
    plain = lambda: attn.relpos_attention_plain(qu, qw, k, v, p, lens, 188)
    # plain, kernel, kernel, plain: drift in clocks shows up as a spread
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    kernel_ms, plain_ms = min(k1, k2), min(p1, p2)
    print(f"timing [{smi}] relpos_attention B={batch} H=8 T=188 Dh=128 bf16: kernel "
          f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")
    return kernel_ms, plain_ms


def time_pipeline(attn, device, smi: str, models, manager, batch: int = 128) -> float:
    rs = np.random.RandomState(3)
    audio = torch.from_numpy(np.stack([speechlike(rs, 15.0) for _ in range(batch)]))
    audio = audio.to(device)
    lengths = torch.full((batch,), WINDOW, dtype=torch.int32, device=device)

    # the encoder layer alone, with the kernel and with the plain attention
    mel, mel_len = models.mel(audio, lengths)
    enc_kernel = lambda: models.encoder(mel, mel_len)
    enc_plain = lambda: models.encoder(mel, mel_len, attention=attn.relpos_attention_plain)
    e = [cuda_ms(f, iters=3) for f in (enc_plain, enc_kernel, enc_kernel, enc_plain)]
    print(f"timing [{smi}] {models.spec.name} encoder B={batch} 15 s: with kernel "
          f"{e[1]:.1f}/{e[2]:.1f} ms, with plain attention {e[0]:.1f}/{e[3]:.1f} ms")
    pipeline = manager.build_pipeline(batch)
    seconds = batch * 15.0
    tps = calibrate_blank_bias(pipeline, models, audio, lengths, seconds)
    check(TARGET_TOK_PER_S[0] <= tps <= TARGET_TOK_PER_S[1],
          f"blank-bias calibration reached {tps} tok/s")
    best = float("inf")
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result, _ = pipeline(audio, lengths)
        result.counts.cpu()  # ends in a device sync
        best = min(best, time.perf_counter() - t0)
    tokens = int(result.counts.sum().item())
    rtfx = seconds / best
    print(f"timing [{smi}] {models.spec.name} build_pipeline({batch}) 15 s windows: "
          f"best of 5 {best * 1e3:.1f} ms -> RTFx {rtfx:.1f} | {tokens / seconds:.2f} tok/s "
          f"of audio | peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return rtfx


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from fluidaudio_tpu_torch.ops import attention as attn

    device = torch.device("cuda", 0)
    smi, _ = phase_device(attn)
    err = phase_kernel_parity(attn, device)
    phase_trained_fixture(device)
    models, manager, launches = phase_v3_requests(attn, device)
    kernel_ms, plain_ms = time_kernel(attn, device, smi)
    time_pipeline(attn, device, smi, models, manager)
    print(json.dumps({"kernels": [{
        "name": "relpos_attention",
        "route": "cuda",
        "source": "fluidaudio_tpu_torch/csrc/relpos_attention.cu",
        "replaces": "fluidaudio_tpu/ops/attention_pallas.py:151",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
