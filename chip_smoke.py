#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`fluidaudio_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a), `nvcc` and
a host C++ compiler; there is no CPU fallback. It imports nothing of JAX or
of the JAX package. Phases, one line each; any failure raises and the final
line is not printed:

  1. device: the card's name and power limit (nvidia-smi), the time to
     build both kernels from `fluidaudio_tpu_torch/csrc/` (one nvcc each, in
     parallel) and the FLAC decoder from `native/flac/flac.cpp` (the host
     C++ compiler, beside them), and what ptxas reports of the attention
     kernel and the int8 GEMM (registers, spills, shared memory);
  2. the rel-pos attention kernel against its plain PyTorch version on the
     card at the v3 shapes (B=4, H=8, T=188, Dh=128, lengths
     [188,100,17,188], bf16; max abs error on valid rows below 0.06), in
     both call forms: contiguous inputs with f32 out, and the encoder's
     strided views with `out=` a bf16 view, which must equal the f32 result
     rounded to bf16 bit for bit; and on the shift-only probe;
  3. the int8 matmul kernel against its plain version at the v3 shapes
     (752 x 1024 x 4096 and 752 x 4096 x 1024 with bias, the 375-row pos
     projection without), the JAX test shapes, and the B=128 encoder shapes
     (24,064 rows at K x N = 1024 x 4096, 4096 x 1024, 1024 x 1024 and
     1024 x 2048, and a ragged 24,065 rows whose last M tile is one row),
     bit for bit, one launch counted per call;
  4. the trained `test-tiny` fixture on the card, f32 and
     quantization="int8": 5- and 40-word utterances, WER printed (gate 0.02
     for f32) and the same text as the port on the CPU;
  5. the main path, Parakeet TDT v3 at full width (24 x 1024, 8 heads, vocab
     8192) with seeded random weights: 5 s, 15 s and ~40 s chunked requests
     through `AsrManager.transcribe` (parallel_chunk_batch=4); the attention
     kernel must launch 24 times per encoder call; then the kernel encoder
     against the plain-attention encoder on one 15 s batch;
  6. the same requests on v3 with quantization="int8" (one of them with
     language="en"): 265 int8 launches and 24 attention launches per encoder
     call; the int8 encoder with the kernel against the int8 encoder with
     the plain int8 matmul on one 15 s x 4 batch; the cosine between the
     int8 and bf16 encoders on the same weights (information only);
  7. timing (CUDA events, card name and power limit on every line): both
     kernels against their plain versions, the attention kernel in both
     call forms at B=128 beside each bound (and, for context only, SDPA
     at the same q/k/v shape without the position term), the int8 kernel at each of the
     five distinct shapes of a B=128 encoder call beside its bound and its
     launches per call (and, for context only, bf16 `F.linear` and
     `torch._int_mm`, which are not the same function), the
     v3 encoder at B=128 in bf16 and int8, and the bf16 and int8
     `build_pipeline(128)` RTFx on 15 s windows with the joint blank bias
     calibrated to 9-12 tokens/s of audio;
  8. the streaming path (no kernel of the port is on it: both counts must
     read 0 after it) on the trained `eou` (320 ms) and `nemotron` (560 ms)
     fixtures with the JAX evaluation's seeds: every final text the known
     transcript and the CPU run's tokens and timestamps, EOU and language
     detect rates >= 0.99, the forced <bb-BB> prefix; multi-stream in
     lockstep and staggered equal to single-stream on the card; a .flac file
     through `audio_io` equal to the array input;
  9. Nemotron-en 0.6B (24 x 1024, 2240 ms) and EOU 120M (17 x 512, 160 ms)
     streaming encoders at full width with seeded random f32 weights: two
     carried chunks against one double-length chunk (2e-2), and the card's
     chunk step against the CPU port's on the same weights (relative L2 of
     the output and every cache field <= 1e-4); then streaming timing (card
     name and power limit on every line): one-stream latency per chunk
     (host wall and CUDA-event span, median of 20) against the chunk's
     duration for EOU 120M at 160/320 ms and Nemotron-en at 560/2240 ms,
     kernel launches and device busy time per chunk step (profiler), and
     Nemotron-en multi-stream at N = 1, 16, 64, 128 streams of 20 s in f32
     and bf16: ms per tick, audio seconds per wall second, peak memory and
     the device's idle share over a tick.

The line before the last is the kernel record (JSON, with each kernel's
launches on its main path, bound and times); the last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
TRAINED = REPO / "fluidaudio_tpu" / "assets" / "trained_tiny"
TRAINED_ASR = TRAINED / "asr"
TRAINED_EOU = TRAINED / "eou"
TRAINED_NEMOTRON = TRAINED / "nemotron"
PARITY_TOL = 0.06  # bf16 inputs, f32 math on both sides (scripts/tpu_kernel_parity.py)
WER_GATE = 0.02
TARGET_TOK_PER_S = (9.0, 12.0)  # LibriSpeech-like emission band of v3
WINDOW = 240_000  # 15 s at 16 kHz
INT8_LAYERS_PER_BLOCK = 11  # ffn{1,2}_fc{1,2}, mhsa.{q,k,v,pos,out}, conv.pointwise{1,2}
# (M, K, N, bias, x and out dtype): v3 fc1/fc2 on 4 x 188 frames, the pos
# projection (2T-1 rows, no bias), the shapes of tests/test_quant_pallas.py
INT8_SHAPES = [(752, 1024, 4096, True, torch.bfloat16), (752, 4096, 1024, True, torch.bfloat16),
               (375, 1024, 1024, False, torch.bfloat16), (37, 128, 130, False, torch.float32),
               (100, 256, 192, True, torch.float32)]
ENCODER_ROWS = 128 * 188  # a B=128 batch of 15 s windows, 188 frames each
# the five distinct int8 shapes of one v3 encoder call at B=128, (name, M, K, N, bias,
# launches per call): 24 blocks x (ffn1 + ffn2 fc1, fc2 + the subsampling projection,
# q/k/v/out + conv pointwise2, conv pointwise1, the 2T-1-row pos projection)
INT8_ENCODER_SHAPES = [("fc1", ENCODER_ROWS, 1024, 4096, True, 48),
                       ("fc2", ENCODER_ROWS, 4096, 1024, True, 49),
                       ("q/k/v/out/pointwise2", ENCODER_ROWS, 1024, 1024, True, 120),
                       ("pointwise1", ENCODER_ROWS, 1024, 2048, True, 24),
                       ("pos", 375, 1024, 1024, False, 24)]
# bit-equal at the real sizes: many persistent tiles per block, K loops that wrap the ring
INT8_ENCODER_PARITY = [(M, K, N, bias, torch.bfloat16)
                       for _, M, K, N, bias, _ in INT8_ENCODER_SHAPES[:4]]
INT8_ENCODER_PARITY.append((ENCODER_ROWS + 1, 4096, 1024, True, torch.bfloat16))
# streaming encoders: chunked against one double chunk (tests/test_streaming_conformer.py),
# and the card's chunk step against the CPU port's in relative L2 (true f32 on both)
CHUNKED_TOL = 2e-2
STREAM_CARD_TOL = 1e-4
# one NVIDIA H100 SXM (data sheet, dense): HBM rate, bf16 and int8 tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12


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


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """The least time in ms the card could take: bytes over the HBM rate or
    operations over the peak, whichever is larger, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_cost(B: int, H: int, T: int, Dh: int, out_bytes: int) -> tuple[int, int]:
    """(bytes, bf16 operations) of one relpos_attention call with every row
    full length: q.k, the shifted q.p band and P.V over every key; bf16 in,
    out in `out_bytes` per element, each read or written once."""
    nbytes = (4 * B * H * T * Dh + H * (2 * T - 1) * Dh) * 2 + B * 4 + B * H * T * Dh * out_bytes
    return nbytes, 3 * 2 * B * H * T * T * Dh


def int8_cost(M: int, K: int, N: int, with_bias: bool, x_bytes: int, out_bytes: int
              ) -> tuple[int, int]:
    """(bytes, int8 operations) of one int8_matmul_fused call: x, the codes,
    the column scales and the bias read once, the output written once."""
    return (M * K * x_bytes + N * K + N * 4 + (N * 4 if with_bias else 0) + M * N * out_bytes,
            2 * M * K * N)


def attention_inputs(B, H, T, Dh, dtype, device, seed, strided=False):
    """qu, qw, k, v [B, H, T, Dh] and p [H, 2T-1, Dh]: contiguous, or (strided)
    the views the encoder passes, of [B, T, H, Dh] and [2T-1, H, Dh] tensors."""
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=device).to(dtype)
    if strided:
        return (*(rnd(B, T, H, Dh).transpose(1, 2) for _ in range(4)),
                rnd(2 * T - 1, H, Dh).transpose(0, 1))
    return rnd(B, H, T, Dh), rnd(B, H, T, Dh), rnd(B, H, T, Dh), rnd(B, H, T, Dh), rnd(
        H, 2 * T - 1, Dh)


def bf16_out(B, H, T, Dh, device) -> torch.Tensor:
    """The encoder's `out=`: the [B, H, T, Dh] view of a [B, T, H, Dh] buffer."""
    return torch.empty(B, T, H, Dh, dtype=torch.bfloat16, device=device).transpose(1, 2)


def int8_inputs(M, K, N, with_bias, dtype, device, seed):
    from fluidaudio_tpu_torch.ops.quant import quantize_cols

    g = torch.Generator(device=device).manual_seed(seed)
    # rows of different magnitudes, so the row scales differ
    x = (torch.randn(M, K, generator=g, device=device)
         * torch.rand(M, 1, generator=g, device=device) * 4).to(dtype)
    wq, ws = quantize_cols(torch.randn(K, N, generator=g, device=device) * K ** -0.5)
    bias = torch.randn(N, generator=g, device=device) * 0.1 if with_bias else None
    return x, wq.T.contiguous(), ws.reshape(-1), bias


def valid_rows_err(a: torch.Tensor, b: torch.Tensor, lengths: list[int]) -> float:
    return max((a[i, :, :n] - b[i, :, :n]).abs().max().item() for i, n in enumerate(lengths))


def reset_launches(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0


def set_int8_matmul(encoder, fn) -> None:
    """Route every Int8Linear of `encoder` through `fn` (the kernel's wrapper
    or its plain version)."""
    from fluidaudio_tpu_torch.ops.quant import Int8Linear

    for m in encoder.modules():
        if isinstance(m, Int8Linear):
            m.matmul = fn


# ---------------------------------------------------------------- phases


def phase_device(attn, i8) -> str:
    from concurrent.futures import ThreadPoolExecutor

    from fluidaudio_tpu_torch.native import flac
    from fluidaudio_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    with ThreadPoolExecutor(1) as pool:  # the host C++ build beside the two nvcc
        flac_build = pool.submit(flac.build_library)
        built = build.build(attn.KERNEL_SOURCE, i8.KERNEL_SOURCE)
        flac_lib, flac_s = flac_build.result()
    cxx = subprocess.run([flac.compiler(), "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.splitlines()[0]
    attn_lib = attn.load_library()
    lib = i8.load_library()
    builds = " | ".join(f"{name} {sec:.2f} s" for name, (sec, _) in built.items())
    print(f"phase 1 device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| kernel builds (parallel nvcc): {builds} | FLAC decoder {flac_lib.name} "
          f"({cxx}, {' '.join(flac.CXX_FLAGS)}): {flac_s:.2f} s")
    report = ptxas_report(built[attn.KERNEL_SOURCE.name][1], "relpos_attention_wgmma")
    print(f"phase 1 relpos_attention_wgmma (nvcc -Xptxas -v): "
          f"{report or 'built before this run'} | dynamic shared memory "
          f"{attn_lib.relpos_attention_smem_bytes(64)} B (Dh <= 64), "
          f"{attn_lib.relpos_attention_smem_bytes(128)} B (Dh 80-128)")
    report = ptxas_report(built[i8.KERNEL_SOURCE.name][1], "int8_gemm_dequant")
    print(f"phase 1 int8_gemm_dequant (nvcc -Xptxas -v): {report or 'built before this run'} | "
          f"dynamic shared memory {lib.int8_gemm_dequant_smem_bytes()} B")
    return smi


def ptxas_report(log: str, kernel: str) -> str:
    """What ptxas printed of each instance of `kernel` (registers, static
    shared memory, spills), one instance per '|', named by its output type
    (and its padded head width, where it has one)."""
    parts, current = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = kernel in line
            if current:
                width = re.search(kernel + r"ILi(\d+)E", line)
                parts.append([f"{f'Dh pad {width.group(1)}, ' if width else ''}"
                              f"{'bf16' if 'bfloat16' in line else 'f32'} out:"])
        elif current and ("spill" in line or "Used" in line):
            parts[-1].append(line.replace("ptxas info    :", "").strip())
    return " | ".join(" ".join(p) for p in parts)


def phase_kernel_parity(attn, device) -> float:
    """Both call forms against the plain version on the same inputs; the
    bf16 out of the strided form must be its own f32 out rounded to bf16."""
    lengths = [188, 100, 17, 188]
    B, H, T, Dh = 4, 8, 188, 128
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    errs = {}
    for form in ("contiguous f32 out", "strided bf16 out"):
        strided = form.startswith("strided")
        qu, qw, k, v, p = attention_inputs(B, H, T, Dh, torch.bfloat16, device, seed=0,
                                           strided=strided)
        got = attn.relpos_attention(qu, qw, k, v, p, lens, T)
        if strided:
            f32 = got
            got = attn.relpos_attention(qu, qw, k, v, p, lens, T, out=bf16_out(B, H, T, Dh, device))
        torch.cuda.synchronize()
        want = attn.relpos_attention_plain(qu, qw, k, v, p, lens, T)
        check(bool(torch.isfinite(got).all()), f"{form}: kernel output not finite")
        errs[form] = valid_rows_err(got.float(), want, lengths)
        check(errs[form] < PARITY_TOL,
              f"{form}: kernel vs plain max abs err {errs[form]} >= {PARITY_TOL}")
        if strided:
            check(torch.equal(got, f32.bfloat16()),
                  f"{form}: {int((got != f32.bfloat16()).sum())} elements differ from the "
                  "f32 out rounded to bf16")
    err = max(errs.values())

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
    forms = " | ".join(f"{form} {e:.3e}" for form, e in errs.items())
    print(f"phase 2 attention kernel vs plain: B=4 H=8 T=188 Dh=128 bf16 lengths {lengths} "
          f"max_abs_err(valid rows): {forms} | strided bf16 out == f32 out rounded to bf16: "
          f"bit-equal | shift-only probe {shift_err:.3e} | tol {PARITY_TOL}")
    return err


def phase_int8_parity(i8, device) -> float:
    """Bit-equal is expected: the kernel rounds exactly where the plain
    version does (IEEE quotient, half to even, exact integer sum, separate
    products and sum), so the tolerance is 0."""
    parts, worst = [], 0.0
    for idx, (M, K, N, with_bias, dtype) in enumerate(INT8_SHAPES + INT8_ENCODER_PARITY):
        x, wq, ws, bias = int8_inputs(M, K, N, with_bias, dtype, device, seed=10 + idx)
        before = i8.int8_matmul_fused.launches
        got = i8.int8_matmul_fused(x, wq, ws, bias, dtype)
        torch.cuda.synchronize()
        check(i8.int8_matmul_fused.launches == before + 1, "one call must count one launch")
        want = i8.int8_matmul_fused_plain(x, wq, ws, bias, dtype)
        check(bool(torch.isfinite(got).all()), f"int8 kernel output not finite at {M}x{K}x{N}")
        err = (got.float() - want.float()).abs().max().item()
        equal = torch.equal(got, want)
        check(equal, f"int8 kernel vs plain at {M}x{K}x{N}: {int((got != want).sum())} "
                     f"elements differ, max abs {err}")
        worst = max(worst, err)
        parts.append(f"{M}x{K}x{N}{' +bias' if with_bias else ''} "
                     f"{str(dtype).removeprefix('torch.')}: bit-equal")
    print(f"phase 3 int8 kernel vs plain (tol 0, bit-equal): {' | '.join(parts)}")
    return worst


def phase_trained_fixture(device) -> None:
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.metrics.wer import wer
    from fluidaudio_tpu_torch.models.zoo import AsrModels
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    def manager(dev, quantization):
        models = AsrModels.load("test-tiny", checkpoint_dir=TRAINED_ASR, device=dev,
                                allow_random_init=False, quantization=quantization)
        return AsrManager(models, ASRConfig(parallel_chunk_batch=2))

    for quantization in ("none", "int8"):
        on_card, on_cpu = manager(device, quantization), manager("cpu", quantization)
        rs = np.random.RandomState(12345)  # the draws of train/fixtures.eval_asr_fixture
        parts = []
        for n in (5, 40):
            ids = rs.randint(0, tc.N_WORDS, size=n)
            audio = tc.make_utterance(ids, rs)
            text = on_card.transcribe(audio).text
            rate = wer(tc.transcript_text(ids), text).rate
            if quantization == "none":
                check(rate <= WER_GATE, f"{n}-word WER {rate} > {WER_GATE}: {text!r}")
            check(text == on_cpu.transcribe(audio).text,
                  f"{quantization}: {n}-word text differs from the CPU run")
            parts.append(f"{n} words WER {rate:.4f}")
        print(f"phase 4 trained test-tiny on card, quantization={quantization}: "
              f"{' | '.join(parts)} | same text as CPU")


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


def v3_requests(attn, i8, device, quantization: str, version: str = "v3"):
    """AsrModels.load -> AsrManager.transcribe at full width, with every
    kernel count set to 0 just before the requests and read just after.
    -> (models, manager, {kernel: launches}, one line of results)."""
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.zoo import AsrModels

    int8 = quantization == "int8"
    t0 = time.perf_counter()
    models = AsrModels.load(version, device=device, allow_random_init=True, rng_seed=0,
                            quantization=quantization)
    manager = AsrManager(models, ASRConfig(parallel_chunk_batch=4))
    load_s = time.perf_counter() - t0
    n_layers = models.spec.conformer.n_layers
    vocab_out = models.spec.predictor.num_token_logits

    rs = np.random.RandomState(0)
    cal = np.stack([speechlike(rs, 15.0) for _ in range(16)])
    tps = calibrate_blank_bias(manager.build_pipeline(16), models, torch.from_numpy(cal),
                               torch.full((16,), WINDOW, dtype=torch.int32), 16 * 15.0)
    requests = [("5s", speechlike(rs, 5.0), None), ("15s", speechlike(rs, 15.0), None),
                ("40s chunked", speechlike(rs, 40.0), None)]
    if int8:
        requests[1] = ("15s en", requests[1][1], "en")

    torch.cuda.synchronize()
    reset_launches(attn.relpos_attention, i8.int8_matmul_fused)
    results = []
    for name, audio, language in requests:
        encoder_calls = encoder_calls_for(manager, audio)
        a0, q0 = attn.relpos_attention.launches, i8.int8_matmul_fused.launches
        t0 = time.perf_counter()
        res = manager.transcribe(audio, language=language)
        wall = time.perf_counter() - t0
        a_n = attn.relpos_attention.launches - a0
        q_n = i8.int8_matmul_fused.launches - q0
        check(a_n == n_layers * encoder_calls,
              f"{name}: {a_n} attention launches, want {n_layers} x {encoder_calls}")
        want_q = (INT8_LAYERS_PER_BLOCK * n_layers + 1) * encoder_calls if int8 else 0
        check(q_n == want_q, f"{name}: {q_n} int8 launches, want {want_q}")
        ids = [t.token_id for t in res.token_timings]
        confs = [t.confidence for t in res.token_timings]
        check(all(0 <= i < vocab_out for i in ids), f"{name}: token id out of range")
        check(bool(np.isfinite(confs).all()) and bool(np.isfinite(res.confidence)),
              f"{name}: non-finite confidences")
        results.append(f"{name}: {len(ids)} tokens, {a_n} attn + {q_n} int8 launches, "
                       f"{wall:.3f} s")
    torch.cuda.synchronize()
    launches = {"relpos_attention": attn.relpos_attention.launches,
                "int8_matmul_fused": i8.int8_matmul_fused.launches}
    check(launches["relpos_attention"] > 0, "the path never launched the attention kernel")
    check(launches["int8_matmul_fused"] > 0 or not int8, "the path never launched int8")
    line = (f"{version} {quantization} full width ({n_layers}x{models.spec.conformer.d_model}, "
            f"load {load_s:.1f} s, calibrated {tps:.2f} tok/s): {' | '.join(results)} | "
            f"launches {launches}")
    return models, manager, launches, line


def encoder_batch(models, device, rs):
    """One 15 s x 4 batch with ragged lengths -> (mel, mel lengths)."""
    lengths = [WINDOW, 160_000, 80_000, WINDOW]
    audio = torch.from_numpy(np.stack([speechlike(rs, 15.0) for _ in lengths])).to(device)
    return models.mel(audio, torch.tensor(lengths, dtype=torch.int32, device=device))


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


def phase_v3_bf16(attn, i8, device):
    """The main path: bf16 v3 requests, then the kernel encoder against the
    plain-attention encoder on one 15 s batch."""
    models, manager, launches, line = v3_requests(attn, i8, device, "none")
    mel, mel_len = encoder_batch(models, device, np.random.RandomState(1))
    enc_k, enc_len = models.encoder(mel, mel_len)
    enc_p, _ = models.encoder(mel, mel_len, attention=attn.relpos_attention_plain)
    check(bool(torch.isfinite(enc_k).all()), "v3 encoder output not finite")
    valid = [int(n) for n in enc_len.tolist()]
    max_abs = max((enc_k[i, :n] - enc_p[i, :n]).abs().max().item() for i, n in enumerate(valid))
    rel = rel_l2(enc_k, enc_p)
    check(rel < 0.05, f"kernel encoder vs plain encoder relative error {rel}")
    print(f"phase 5 {line} | encoder kernel vs plain attention on 15 s x4: max_abs "
          f"{max_abs:.3e} rel {rel:.3e} ({models.spec.conformer.dtype})")
    return models, manager, launches, (mel, mel_len, enc_k)


def phase_v3_int8(attn, i8, device, bf16_encoded):
    """The int8 path: the same requests on v3 with quantization="int8", then
    the int8 encoder with the kernel against the int8 encoder with the plain
    int8 matmul, and the cosine to the bf16 encoder on the same weights."""
    models, manager, launches, line = v3_requests(attn, i8, device, "int8")
    mel, mel_len, enc_bf16 = bf16_encoded
    enc_k, enc_len = models.encoder(mel, mel_len)
    set_int8_matmul(models.encoder, i8.int8_matmul_fused_plain)
    enc_p, _ = models.encoder(mel, mel_len)
    set_int8_matmul(models.encoder, i8.int8_matmul_fused)
    check(bool(torch.isfinite(enc_k).all()), "v3 int8 encoder output not finite")
    rel = rel_l2(enc_k, enc_p)
    check(rel < 0.05, f"int8 kernel encoder vs plain int8 encoder relative error {rel}")
    cos = torch.nn.functional.cosine_similarity(enc_k.flatten(), enc_bf16.flatten(), dim=0)
    print(f"phase 6 {line} | int8 encoder kernel vs plain int8 matmul on 15 s x4: rel "
          f"{rel:.3e}, bit-equal {torch.equal(enc_k, enc_p)} | cosine int8 vs bf16 encoder "
          f"(same weights, information only) {cos.item():.5f}")
    return models, manager, launches


def time_attention(attn, device, smi: str, batch: int = 128) -> dict:
    """Both call forms at B=128, each in turns (plain, kernel, kernel, plain)
    beside its bound. No PyTorch call computes the XL-shifted scores, so
    `library_ms` is None; SDPA at the same q/k/v shape without the position
    term is printed as context (the port never calls it). -> the encoder
    form's record."""
    B, H, T, Dh = batch, 8, 188, 128
    lens = torch.full((B,), T, dtype=torch.int32, device=device)
    record = {}
    for form in ("contiguous f32 out", "strided bf16 out"):
        strided = form.startswith("strided")
        qu, qw, k, v, p = attention_inputs(B, H, T, Dh, torch.bfloat16, device, seed=1,
                                           strided=strided)
        out = bf16_out(B, H, T, Dh, device) if strided else None
        kernel = lambda: attn.relpos_attention(qu, qw, k, v, p, lens, T, out=out)
        plain = lambda: attn.relpos_attention_plain(qu, qw, k, v, p, lens, T, out=out)
        # plain, kernel, kernel, plain: drift in clocks shows up as a spread
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
        # all rows are full length here
        nbytes, ops = attention_cost(B, H, T, Dh, 2 if strided else 4)
        bound_ms, bound_by = bound(nbytes, ops, BF16_FLOPS)
        print(f"timing [{smi}] relpos_attention B={B} H={H} T={T} Dh={Dh} bf16, {form}: "
              f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB), "
              f"{bound_ms / min(k1, k2):.0%} of it")
        record = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": None}
    q, kk, vv = (x.contiguous() for x in (qu, k, v))
    sdpa = [cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, kk, vv))
            for _ in range(2)]
    print(f"timing [{smi}] context, not the same function: SDPA on q/k/v [{B}, {H}, {T}, "
          f"{Dh}] bf16 without the position term {sdpa[0]:.4f}/{sdpa[1]:.4f} ms; no PyTorch "
          f"call computes the XL-shifted scores")
    return record


def time_int8(i8, device, smi: str) -> dict:
    """The five distinct int8 shapes of a B=128 encoder call, each beside its
    bound and its launches per call, in turns (plain, kernel, kernel,
    plain). bf16 `F.linear` and `torch._int_mm` (the int8 product alone)
    are context, not the same function; no single PyTorch call quantises,
    multiplies and dequantises. -> the fc1 shape's record."""
    out, per_call, bound_per_call = {}, 0.0, 0.0
    check(sum(n for *_, n in INT8_ENCODER_SHAPES) == INT8_LAYERS_PER_BLOCK * 24 + 1,
          "the encoder shapes must cover all 265 launches")
    for name, M, K, N, with_bias, launches in INT8_ENCODER_SHAPES:
        x, wq, ws, bias = int8_inputs(M, K, N, with_bias, torch.bfloat16, device, seed=K + N)
        kernel = lambda: i8.int8_matmul_fused(x, wq, ws, bias, torch.bfloat16)
        plain = lambda: i8.int8_matmul_fused_plain(x, wq, ws, bias, torch.bfloat16)
        p1, k1, k2, p2 = (cuda_ms(plain, 5), cuda_ms(kernel), cuda_ms(kernel),
                          cuda_ms(plain, 5))
        w_bf16 = (wq.float() * ws[:, None]).bfloat16()
        b_bf16 = None if bias is None else bias.bfloat16()
        linear_ms = cuda_ms(lambda: torch.nn.functional.linear(x, w_bf16, b_bf16))
        xq = i8.quantize_rows(x)[0]
        try:
            int_mm = f"{cuda_ms(lambda: torch._int_mm(xq, wq.T)):.4f} ms"
        except RuntimeError as e:  # context only: the port never calls it
            int_mm = f"not measured ({str(e).splitlines()[0][:80]})"
        nbytes, ops = int8_cost(M, K, N, with_bias, 2, 2)
        bound_ms, bound_by = bound(nbytes, ops, INT8_OPS)
        per_call += launches * min(k1, k2)
        bound_per_call += launches * bound_ms
        print(f"timing [{smi}] int8_matmul_fused {name} M={M} K={K} N={N} bf16"
              f"{' +bias' if with_bias else ''}, {launches} launches per encoder call: kernel "
              f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}) | context, not the same function: bf16 F.linear "
              f"{linear_ms:.4f} ms, torch._int_mm {int_mm}")
        if not out:  # the fc1 shape goes into the kernel record
            out = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": None}
        del x, wq, ws, bias, xq, w_bf16
    print(f"timing [{smi}] int8_matmul_fused per B=128 encoder call (sum of launches x best "
          f"time above): {per_call:.3f} ms against a summed bound of {bound_per_call:.3f} ms")
    return out


def time_encoders(attn, device, smi: str, bf16_models, int8_models, batch: int = 128) -> None:
    rs = np.random.RandomState(3)
    audio = torch.from_numpy(np.stack([speechlike(rs, 15.0) for _ in range(batch)])).to(device)
    lengths = torch.full((batch,), WINDOW, dtype=torch.int32, device=device)
    mel, mel_len = bf16_models.mel(audio, lengths)
    bf16 = lambda: bf16_models.encoder(mel, mel_len)
    bf16_plain = lambda: bf16_models.encoder(mel, mel_len, attention=attn.relpos_attention_plain)
    int8 = lambda: int8_models.encoder(mel, mel_len)
    e = [cuda_ms(f, iters=3) for f in (bf16_plain, bf16, bf16, bf16_plain)]
    print(f"timing [{smi}] v3 encoder B={batch} 15 s: bf16 with kernel {e[1]:.1f}/{e[2]:.1f} "
          f"ms, bf16 with plain attention {e[0]:.1f}/{e[3]:.1f} ms")
    q = [cuda_ms(f, iters=3) for f in (bf16, int8, int8, bf16)]
    print(f"timing [{smi}] v3 encoder B={batch} 15 s: int8 {q[1]:.1f}/{q[2]:.1f} ms, "
          f"bf16 {q[0]:.1f}/{q[3]:.1f} ms")


def time_pipeline(device, smi: str, models, manager, batch: int = 128) -> float:
    rs = np.random.RandomState(3)
    audio = torch.from_numpy(np.stack([speechlike(rs, 15.0) for _ in range(batch)]))
    audio = audio.to(device)
    lengths = torch.full((batch,), WINDOW, dtype=torch.int32, device=device)
    pipeline = manager.build_pipeline(batch)
    seconds = batch * 15.0
    tps = calibrate_blank_bias(pipeline, models, audio, lengths, seconds)
    check(TARGET_TOK_PER_S[0] <= tps <= TARGET_TOK_PER_S[1],
          f"blank-bias calibration reached {tps} tok/s")
    torch.cuda.reset_peak_memory_stats()
    best = float("inf")
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result, _ = pipeline(audio, lengths)
        result.counts.cpu()  # ends in a device sync
        best = min(best, time.perf_counter() - t0)
    tokens = int(result.counts.sum().item())
    rtfx = seconds / best
    print(f"timing [{smi}] {models.spec.name} {models.spec.conformer.quantization} "
          f"build_pipeline({batch}) 15 s windows: best of 5 {best * 1e3:.1f} ms -> RTFx "
          f"{rtfx:.1f} | {tokens / seconds:.2f} tok/s of audio | peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return rtfx


# ------------------------------------------------------- streaming phases


def flac_bytes(pcm: np.ndarray, sample_rate: int = 16_000, block: int = 4096) -> bytes:
    """int16 mono PCM -> a FLAC stream of verbatim subframes (STREAMINFO, then
    frames with a 16-bit block size; CRCs zero, the decoder does not check
    them), so the FLAC input path can be driven without an encoder."""
    bits, acc, out = 0, 0, bytearray(b"fLaC")

    def put(value: int, n: int) -> None:
        nonlocal bits, acc
        acc = (acc << n) | (value & ((1 << n) - 1))
        bits += n
        while bits >= 8:
            bits -= 8
            out.append((acc >> bits) & 0xFF)
        acc &= (1 << bits) - 1

    x = np.asarray(pcm, np.int16).astype(np.int64)
    put(1, 1); put(0, 7); put(34, 24)  # last metadata block: STREAMINFO, 34 bytes
    put(block, 16); put(block, 16); put(0, 24); put(0, 24)
    put(sample_rate, 20); put(0, 3); put(15, 5); put(x.size, 36); put(0, 64); put(0, 64)
    for index, start in enumerate(range(0, x.size, block)):
        frame = x[start:start + block]
        put(0x3FFE, 14); put(0, 2); put(7, 4); put(0, 4); put(0, 4); put(0b100, 3); put(0, 1)
        if index < 0x80:  # the frame number, UTF-8 coded
            put(index, 8)
        else:
            put(0xC0 | (index >> 6), 8); put(0x80 | (index & 0x3F), 8)
        put(frame.size - 1, 16); put(0, 8)  # block size - 1, header CRC-8
        put(0, 1); put(1, 6); put(0, 1)  # verbatim subframe, no wasted bits
        for v in frame:
            put(int(v), 16)
        if bits:
            put(0, 8 - bits)
        put(0, 16)  # frame CRC-16
    return bytes(out)


def eou_fixture_utterances(seed: int = 2468, n: int = 6):
    """The draws of the JAX package's `eval_eou_fixture`: (reference text,
    audio followed by 1.28 s of open-mic silence)."""
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    rs = np.random.RandomState(seed)
    tail = np.zeros(int(1.28 * 16_000), np.float32)
    out = []
    for _ in range(n):
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 8)))
        out.append((tc.transcript_text(ids), np.concatenate([tc.make_utterance(ids, rs), tail])))
    return out


def nemotron_fixture_utterances(seed: int = 9753, n: int = 6):
    """The draws of `eval_nemotron_fixture`: (language, reference, audio),
    alternating the fixture's two languages."""
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    rs = np.random.RandomState(seed)
    out = []
    for u in range(n):
        lang = "a" if u % 2 == 0 else "b"
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 8)))
        audio = tc.make_utterance(ids, rs, lang=lang)
        words = (tc.word_text(i) if lang == "a" else tc.word_text_b(i) for i in ids)
        out.append(("aa-AA" if lang == "a" else "bb-BB", " ".join(words), audio))
    return out


def fixture_managers(dev):
    """The port's managers on the trained `eou` (320 ms) and `nemotron`
    (560 ms, auto) fixtures on `dev`."""
    from fluidaudio_tpu_torch.asr.streaming_eou import EOU_TEST, StreamingEouAsrManager
    from fluidaudio_tpu_torch.asr.streaming_nemotron import (
        NEMOTRON_TEST, StreamingNemotronAsrManager)

    eou = StreamingEouAsrManager(chunk_ms=320, spec=EOU_TEST, checkpoint_dir=TRAINED_EOU,
                                 device=dev)
    nem = StreamingNemotronAsrManager(NEMOTRON_TEST, 560, language="auto",
                                      enc_cfg=EOU_TEST.enc_cfg,
                                      checkpoint_dir=TRAINED_NEMOTRON, device=dev)
    return eou, nem


def run_stream(mgr, audio, language=None, forced_prefix=None):
    """One utterance through the single-stream path -> (state, partials, final)."""
    if language is not None:
        mgr.set_language(language)
    state = mgr.make_state() if forced_prefix is None else mgr.make_state(forced_prefix)
    partials = mgr.process(audio, state)
    return state, partials, mgr.finish(state)


def serve(mgr, session, audios, steps=None):
    """Feed a multi-stream session in lockstep (steps None) or in unequal
    slices per stream; flush -> (finals, partials per stream)."""
    partials = [[] for _ in audios]
    if steps is None:
        partials = mgr.process_multi(session, audios)
    else:
        offsets = [0] * len(audios)
        while any(o < a.size for o, a in zip(offsets, audios)):
            feed = [a[o:o + s] if o < a.size else None
                    for a, o, s in zip(audios, offsets, steps)]
            offsets = [o + s for o, s in zip(offsets, steps)]
            for i, p in enumerate(mgr.process_multi(session, feed)):
                partials[i].extend(p)
    return mgr.flush_multi(session), partials


def same_tokens(a, b) -> bool:
    return a.token_ids == b.token_ids and a.timestamps_ms == b.timestamps_ms


def phase_streaming_fixtures(attn, i8, device) -> dict:
    """The streaming main path on the trained fixtures: the EOU and Nemotron
    managers on the card with the JAX evaluation's seeds and loops, against
    the known transcripts and the same managers on the CPU; multi-stream in
    lockstep and staggered against single-stream on the card; a .flac file
    through `audio_io`. Neither kernel is on this path: every count is set
    to 0 before it and must read 0 after. -> {kernel: launches}."""
    import tempfile

    from fluidaudio_tpu_torch.metrics.wer import wer
    from fluidaudio_tpu_torch.utils import audio_io

    eou, nem = fixture_managers(device)
    eou_cpu, nem_cpu = fixture_managers("cpu")
    events = []
    eou.on_eou = events.append
    torch.cuda.synchronize()
    reset_launches(attn.relpos_attention, i8.int8_matmul_fused)

    rates, detected = [], 0
    for ref, audio in eou_fixture_utterances():
        events.clear()
        _, _, final = run_stream(eou, audio)
        rates.append(wer(ref, final.text).rate)
        detected += bool(events)
        check(final.text == ref, f"EOU fixture on card: {final.text!r} != {ref!r}")
        check(same_tokens(final, run_stream(eou_cpu, audio)[2]),
              f"EOU fixture: card tokens/timestamps differ from the CPU's for {ref!r}")
    eou_wer, eou_rate = float(np.mean(rates)), detected / len(rates)
    check(eou_wer <= WER_GATE and eou_rate >= 0.99,
          f"EOU fixture WER {eou_wer} / EOU detect rate {eou_rate}")

    rates, detected = [], 0
    for lang, ref, audio in nemotron_fixture_utterances():
        _, _, final = run_stream(nem, audio, lang)
        rates.append(wer(ref, final.text).rate)
        check(final.text == ref, f"Nemotron fixture ({lang}) on card: {final.text!r} != {ref!r}")
        check(same_tokens(final, run_stream(nem_cpu, audio, lang)[2]),
              f"Nemotron fixture: card tokens/timestamps differ from the CPU's for {ref!r}")
        state, _, _ = run_stream(nem, audio, "auto")
        detected += state.detected_language == lang
    nem_wer, lang_rate = float(np.mean(rates)), detected / len(rates)
    check(nem_wer <= WER_GATE and lang_rate >= 0.99,
          f"Nemotron fixture WER {nem_wer} / language detect rate {lang_rate}")

    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    rs = np.random.RandomState(91)  # the forced-prefix draw of the JAX fixture test
    ids = rs.randint(0, tc.N_WORDS, size=4)
    bb_audio = tc.make_utterance(ids, rs, lang="b")
    tag = nem.lang_tag_token("bb-BB")
    _, _, forced = run_stream(nem, bb_audio, "auto", forced_prefix=tag)
    want = " ".join(tc.word_text_b(int(i)) for i in ids)
    check(forced.text == want, f"forced <bb-BB> prefix: {forced.text!r} != {want!r}")

    # multi-stream on the card against single-stream on the card
    eou.on_eou = None
    utts = [a for _, a in eou_fixture_utterances(seed=97, n=3)]
    singles = [run_stream(eou, a) for a in utts]
    for steps in (None, [7000, 3000, 12000]):
        finals, partials = serve(eou, eou.make_multi_state(3), utts, steps)
        for i, (_, ref_partials, ref_final) in enumerate(singles):
            check(same_tokens(finals[i], ref_final) and
                  [p.eou_detected for p in partials[i]] == [p.eou_detected for p in ref_partials],
                  f"EOU multi-stream ({'lockstep' if steps is None else 'staggered'}) stream {i} "
                  "differs from single-stream")
    langs = ["aa-AA", "bb-BB", "auto", "aa-AA"]
    utts = [a for _, _, a in nemotron_fixture_utterances(seed=5151, n=4)]
    singles = [run_stream(nem, a, lang) for a, lang in zip(utts, langs)]
    for steps in (None, [9000, 4000, 13000, 6000]):
        session = nem.make_multi_state(4, languages=langs)
        finals, _ = serve(nem, session, utts, steps)
        for i, (state, _, ref_final) in enumerate(singles):
            check(same_tokens(finals[i], ref_final)
                  and session.streams[i].detected_language == state.detected_language,
                  f"Nemotron multi-stream stream {i} differs from single-stream")

    # FLAC input: the first EOU utterance as a .flac file
    ref, audio = eou_fixture_utterances(n=1)[0]
    pcm = np.clip(np.round(audio * 32768.0), -32768, 32767).astype(np.int16)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "utterance.flac"
        path.write_bytes(flac_bytes(pcm))
        from_flac, rate = audio_io.read_audio(path)
    check(rate == 16_000 and np.array_equal(from_flac[:, 0], pcm / np.float32(32768.0)),
          "the .flac read back differs from its PCM")
    flac_final = run_stream(eou, from_flac[:, 0])[2]
    check(flac_final.text == ref and same_tokens(flac_final, run_stream(eou, pcm / 32768.0)[2]),
          f"EOU on the .flac input: {flac_final.text!r}")

    torch.cuda.synchronize()
    launches = {"relpos_attention": attn.relpos_attention.launches,
                "int8_matmul_fused": i8.int8_matmul_fused.launches}
    check(not any(launches.values()), f"the streaming path launched {launches}: it has no kernel")
    print(f"phase 8 streaming fixtures on card: EOU 320 ms x6 WER {eou_wer:.4f}, EOU detect "
          f"rate {eou_rate:.2f} | Nemotron 560 ms x6 WER {nem_wer:.4f}, language detect rate "
          f"{lang_rate:.2f}, forced <bb-BB> prefix {forced.text!r} | every text the known "
          f"transcript, tokens and timestamps equal to the CPU run | multi-stream (EOU x3, "
          f"Nemotron x4 per-stream prompts) lockstep and staggered == single-stream | .flac "
          f"input == array input | kernel launches on this path {launches}")
    return launches


def stream_mel_chunks(mgr_mel, chunk_samples: int, n_chunks: int, rs, device):
    """Speech-like audio cut as the managers cut it -> n_chunks mel chunks
    [1, 128, chunk_samples / 160] (look-ahead windows, last sample carried)."""
    audio = speechlike(rs, (n_chunks * chunk_samples + 240) / 16_000)
    chunks, last = [], 0.0
    for i in range(n_chunks):
        window = torch.from_numpy(audio[i * chunk_samples:(i + 1) * chunk_samples + 240])
        mel, _ = mgr_mel(window[None].to(device),
                         last_samples=torch.tensor([last], device=device))
        chunks.append(mel[:, :, :chunk_samples // 160])
        last = float(audio[(i + 1) * chunk_samples - 1])
    return chunks


def phase_streaming_full_width(device, name: str, enc_cfg, chunk_ms: int) -> str:
    """One full-width streaming encoder (seeded random f32 weights): on the
    card, two chunks carried against one double-length chunk; and the card's
    chunk step against the CPU port's on the same weights and mel, for 2
    chunks at 1 stream (relative L2 of the output and of every cache
    field)."""
    import copy

    from fluidaudio_tpu_torch.models.conformer_streaming import (
        StreamingConformerEncoder, init_caches)
    from fluidaudio_tpu_torch.models.zoo import random_init_
    from fluidaudio_tpu_torch.ops.mel import MelConfig, MelFrontend

    cpu_enc = StreamingConformerEncoder(enc_cfg).eval()
    random_init_(cpu_enc, torch.Generator().manual_seed(0))
    card_enc = copy.deepcopy(cpu_enc).to(device)
    chunk_samples = chunk_ms * 16
    mel = stream_mel_chunks(MelFrontend(MelConfig(center=False, normalize=None), device="cpu"),
                            chunk_samples, 2, np.random.RandomState(chunk_ms), "cpu")

    caches = init_caches(enc_cfg, 1, device)
    outs = []
    for m in mel:
        out, caches = card_enc(m.to(device), caches)
        outs.append(out)
    chunked = torch.cat(outs, dim=1)
    full, _ = card_enc(torch.cat(mel, dim=2).to(device), init_caches(enc_cfg, 1, device))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(full).all()), f"{name}: encoder output not finite")
    chunk_err = (chunked - full).abs().max().item()
    check(torch.allclose(chunked, full, rtol=CHUNKED_TOL, atol=CHUNKED_TOL),
          f"{name}: two carried chunks vs one double chunk max abs {chunk_err}")

    card_c, cpu_c = init_caches(enc_cfg, 1, device), init_caches(enc_cfg, 1, "cpu")
    worst = {}
    for m in mel:
        got, card_c = card_enc(m.to(device), card_c)
        want, cpu_c = cpu_enc(m, cpu_c)
        pairs = [("enc", got, want)] + [(f, getattr(card_c, f), getattr(cpu_c, f))
                                        for f in ("pre_cache", "channel", "time")]
        for field, g, w in pairs:
            worst[field] = max(worst.get(field, 0.0), rel_l2(g.float().cpu(), w.float()))
        check(torch.equal(card_c.channel_len.cpu(), cpu_c.channel_len), f"{name}: channel_len")
    check(max(worst.values()) <= STREAM_CARD_TOL,
          f"{name}: card vs CPU relative L2 {worst} > {STREAM_CARD_TOL}")
    errs = ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
    line = (f"{name} ({enc_cfg.n_layers}x{enc_cfg.d_model}, {enc_cfg.n_heads} heads, C="
            f"{enc_cfg.att_context_left}, f32) {chunk_ms} ms: 2 carried chunks vs 1 double "
            f"chunk on card max abs {chunk_err:.3e} (tol {CHUNKED_TOL}) | card vs CPU, 1 stream "
            f"x 2 chunks, relative L2: {errs} (tol {STREAM_CARD_TOL}), channel_len equal")
    return line


def busy_ms(kernels) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    total, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def profile_calls(fn, n: int) -> tuple[float, float]:
    """torch.profiler over n calls of fn -> (kernel launches per call, device
    busy ms per call). Copies and memsets are busy time, not launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(bool(device), "the profiler recorded no device time")
    kernels = [e for e in device if not e.name.startswith(("Memcpy", "Memset"))]
    return len(kernels) / n, busy_ms(device) / n


def calibrate_stream_blank_bias(mgr, rs, chunks: int, streams: int = 8) -> float:
    """Bisect the joint's blank-logit bias until the streaming decode emits
    9-12 tokens per second of speech-like audio over `streams` streams of
    `chunks` chunks each, the length of the run it calibrates for (a random
    model's emission rate drifts as its caches fill); higher bias, fewer
    emissions. Sets it in place -> the tokens/s reached."""
    audios = [speechlike(rs, (chunks * mgr.chunk_samples + 240) / 16_000)
              for _ in range(streams)]
    seconds = streams * chunks * mgr.chunk_ms / 1000
    bias, blank = mgr.joint.out.bias, mgr.dcfg.blank_id
    lo, hi, tps = -12.0, 12.0, 0.0
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        with torch.no_grad():
            bias[blank] = mid
        session = mgr.make_multi_state(streams)
        mgr.process_multi(session, audios)
        tps = sum(len(s.tokens) for s in session.streams) / seconds
        if TARGET_TOK_PER_S[0] <= tps <= TARGET_TOK_PER_S[1]:
            break
        lo, hi = (mid, hi) if tps > TARGET_TOK_PER_S[1] else (lo, mid)
    return tps


def time_stream_latency(smi: str, name: str, mgr, chunks: int = 20) -> None:
    """One stream, one chunk per `process` call after 3 warm-up chunks: host
    wall (median) and the CUDA-event span of the same call (median) against
    the chunk's own duration; then kernel launches and device busy time per
    chunk step from the profiler over 5 more chunks."""
    rs = np.random.RandomState(mgr.chunk_ms)
    n = 3 + chunks + 5
    audio = speechlike(rs, (n * mgr.chunk_samples + 240) / 16_000)
    state = mgr.make_state()
    mgr.process(audio[:240], state)  # the look-ahead, so each call below runs one chunk
    pieces = iter(audio[240 + i * mgr.chunk_samples:240 + (i + 1) * mgr.chunk_samples]
                  for i in range(n))
    for _ in range(3):
        mgr.process(next(pieces), state)
    walls, spans, emitted = [], [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(chunks):
        piece = next(pieces)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        done = mgr.process(piece, state)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        spans.append(start.elapsed_time(end))
        check(len(done) == 1, "one chunk per call")
        emitted.append(len(done[0].token_ids))
    launches, busy = profile_calls(lambda: mgr.process(next(pieces), state), 5)
    wall = float(np.median(walls))
    print(f"timing [{smi}] streaming latency {name} {mgr.chunk_ms} ms chunks, 1 stream, f32: "
          f"median wall {wall:.3f} ms per chunk (CUDA-event span {np.median(spans):.3f} ms), "
          f"{wall / mgr.chunk_ms:.4f} of the chunk's duration | {launches:.1f} kernel launches "
          f"and {busy:.3f} ms device busy per chunk step (profiler), idle share "
          f"{max(0.0, 1 - busy / wall):.3f} | tokens per timed chunk: mean "
          f"{np.mean(emitted):.2f}, max {max(emitted)} "
          f"({sum(emitted) / (chunks * mgr.chunk_ms / 1000):.2f} tok/s of audio)")


def time_multistream(device, smi: str, mgr, label: str, counts=(1, 16, 64, 128),
                     seconds: float = 20.0) -> None:
    """N streams of speech-like audio through one multi-stream session in
    lockstep: ms per tick, audio seconds served per wall second, peak memory,
    decode loop steps per tick (joint calls); then one more steady tick under
    the profiler (launches, device busy, idle share against the unprofiled
    tick), and the encoder chunk step alone at batch N (CUDA events)."""
    rs = np.random.RandomState(20)
    pool = [speechlike(rs, seconds) for _ in range(max(counts))]
    ticks, steps = [0], [0]
    serve_tick = mgr._serve_tick

    def counting_tick(*args):
        ticks[0] += 1
        return serve_tick(*args)

    mgr._serve_tick = counting_tick
    hook = mgr.joint.register_forward_pre_hook(lambda *_: steps.__setitem__(0, steps[0] + 1))
    try:
        for n in counts:
            audios = pool[:n]
            warm = mgr.make_multi_state(n)
            mgr.process_multi(warm, [a[:mgr._need] for a in audios])  # one warm-up tick
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            session = mgr.make_multi_state(n)
            ticks[0] = steps[0] = 0
            t0 = time.perf_counter()
            partials = mgr.process_multi(session, audios)
            mgr.flush_multi(session)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_ticks, n_steps = ticks[0], steps[0]
            per_tick = wall / n_ticks * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30
            tokens = sum(len(s.tokens) for s in session.streams)
            burst = max(len(p.token_ids) for ps in partials for p in ps)
            # a steady tick: the same streams, one more chunk each
            launches, busy = profile_calls(lambda: mgr.process_multi(
                session, [a[-mgr.chunk_samples:] for a in audios]), 1)
            win = torch.from_numpy(np.stack([a[:mgr._need] for a in audios])).to(device)
            mel = mgr._mel_chunk(win, torch.zeros(n, device=device))
            pid = torch.from_numpy(session.prompt_ids).to(device)
            enc_ms = cuda_ms(lambda: mgr._apply_encoder(mel, session.caches, pid), iters=5)
            print(f"timing [{smi}] multi-stream {label} {mgr.chunk_ms} ms chunks, N={n} x "
                  f"{seconds:.0f} s: {n_ticks} ticks, {per_tick:.2f} ms per tick "
                  f"({'real time' if per_tick < mgr.chunk_ms else 'NOT real time'} against "
                  f"{mgr.chunk_ms} ms of audio per tick), {n * seconds / wall:.1f} audio s per "
                  f"wall s, peak mem {peak:.2f} GiB, {n_steps / n_ticks:.1f} decode loop steps "
                  f"per tick | one steady tick: {launches:.0f} kernel launches, device busy "
                  f"{busy:.2f} ms, idle share {max(0.0, 1 - busy / per_tick):.3f} | encoder "
                  f"chunk step alone at N={n}: {enc_ms:.2f} ms (CUDA events) | "
                  f"{tokens / (n * seconds):.2f} tok/s of audio, at most {burst} tokens in one "
                  f"stream's chunk (the decode loop runs to the busiest row)")
    finally:
        mgr._serve_tick = serve_tick
        hook.remove()


def streaming_full_width(attn, i8, device, smi: str) -> None:
    """Phase 9 (parity at full width) and the streaming timing lines, with
    every kernel count set to 0 before and read after (the streaming path
    launches neither kernel)."""
    import dataclasses

    from fluidaudio_tpu_torch.asr.streaming_eou import EOU_DEFAULT, StreamingEouAsrManager
    from fluidaudio_tpu_torch.asr.streaming_nemotron import (
        NEMOTRON_EN, StreamingNemotronAsrManager)
    from fluidaudio_tpu_torch.models.conformer_streaming import (
        EOU_120M, NEMOTRON_EN as NEMOTRON_EN_ENC)
    from fluidaudio_tpu_torch.utils.weights import load_state

    torch.cuda.synchronize()
    reset_launches(attn.relpos_attention, i8.int8_matmul_fused)
    lines = [phase_streaming_full_width(device, "Nemotron-en 0.6B", NEMOTRON_EN_ENC, 2240),
             phase_streaming_full_width(device, "EOU 120M", EOU_120M, 160)]
    print(f"phase 9 streaming encoders at full width: {' | '.join(lines)}")

    rs = np.random.RandomState(7)
    eou = {ms: StreamingEouAsrManager(ms, spec=EOU_DEFAULT, device=device) for ms in (160, 320)}
    nem = {ms: StreamingNemotronAsrManager(NEMOTRON_EN, ms, device=device) for ms in (560, 2240)}
    # each manager calibrated over about the length of its timed run: 16 of
    # the 28 chunks of a latency run, 20 s (9 chunks) for the 2240 ms
    # multi-stream runs
    tps = {f"EOU 120M {ms} ms": calibrate_stream_blank_bias(m, rs, 16) for ms, m in eou.items()}
    tps["Nemotron-en 560 ms"] = calibrate_stream_blank_bias(nem[560], rs, 16)
    tps["Nemotron-en 2240 ms"] = calibrate_stream_blank_bias(nem[2240], rs, 9)
    print(f"timing [{smi}] streaming managers at full width, seeded random weights, joint blank "
          f"bias calibrated on 8 streams of speech-like audio to tok/s: "
          + ", ".join(f"{k} {v:.2f}" for k, v in tps.items()))
    for mgr in eou.values():
        time_stream_latency(smi, "EOU 120M", mgr)
    for mgr in nem.values():
        time_stream_latency(smi, "Nemotron-en 0.6B", mgr)
    del eou, nem[560]

    f32 = nem[2240]
    time_multistream(device, smi, f32, "Nemotron-en 0.6B f32")
    bf16 = StreamingNemotronAsrManager(
        NEMOTRON_EN, 2240, device=device,
        enc_cfg=dataclasses.replace(f32.enc_cfg, dtype="bfloat16"))
    for part in ("encoder", "predictor", "joint"):
        load_state(getattr(bf16, part), getattr(f32, part).state_dict())
    del f32, nem
    torch.cuda.empty_cache()
    time_multistream(device, smi, bf16, "Nemotron-en 0.6B bf16")
    torch.cuda.synchronize()
    launches = {"relpos_attention": attn.relpos_attention.launches,
                "int8_matmul_fused": i8.int8_matmul_fused.launches}
    check(not any(launches.values()), f"the streaming path launched {launches}: it has no kernel")
    print(f"phase 9 streaming path at full width (EOU 120M, Nemotron-en 0.6B f32 and bf16): "
          f"kernel launches {launches}, as neither kernel is on it")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from fluidaudio_tpu_torch.ops import attention as attn
    from fluidaudio_tpu_torch.ops import int8_matmul as i8

    device = torch.device("cuda", 0)
    smi = phase_device(attn, i8)
    attn_err = phase_kernel_parity(attn, device)
    int8_err = phase_int8_parity(i8, device)
    phase_trained_fixture(device)
    bf16_models, bf16_manager, bf16_launches, encoded = phase_v3_bf16(attn, i8, device)
    int8_models, int8_manager, int8_launches = phase_v3_int8(attn, i8, device, encoded)
    del encoded
    attn_t = time_attention(attn, device, smi)
    int8_t = time_int8(i8, device, smi)
    time_encoders(attn, device, smi, bf16_models, int8_models)
    time_pipeline(device, smi, bf16_models, bf16_manager)
    time_pipeline(device, smi, int8_models, int8_manager)
    del bf16_models, bf16_manager, int8_models, int8_manager
    torch.cuda.empty_cache()
    phase_streaming_fixtures(attn, i8, device)
    streaming_full_width(attn, i8, device, smi)
    print(json.dumps({"kernels": [{
        "name": "relpos_attention",
        "route": "cuda",
        "source": "fluidaudio_tpu_torch/csrc/relpos_attention.cu",
        "replaces": "fluidaudio_tpu/ops/attention_pallas.py:151",
        "launches": bf16_launches["relpos_attention"],
        "max_abs_err": attn_err,
        **attn_t,
    }, {
        "name": "int8_matmul_fused",
        "route": "cuda",
        "source": "fluidaudio_tpu_torch/csrc/int8_matmul_fused.cu",
        "replaces": "fluidaudio_tpu/ops/quant_pallas.py:107",
        "launches": int8_launches["int8_matmul_fused"],
        "max_abs_err": int8_err,
        **int8_t,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
