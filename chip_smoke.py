#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`fluidaudio_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a), `nvcc` and
a host C++ compiler; there is no CPU fallback. It imports nothing of JAX or
of the JAX package. Phases, one line each; any failure raises and the final
line is not printed:

  1. device: the card's name and power limit (nvidia-smi), the time to
     build both kernels from `fluidaudio_tpu_torch/csrc/` (one nvcc each, in
     parallel) and the FLAC decoder, the fastcluster library and the ITN
     engine from `native/{flac,fastcluster,itn}/` (the host C++ compiler,
     beside them) and the sysinfo shim from `native/sysinfo/sysinfo.c` (the
     host C compiler), and
     what ptxas reports of the attention kernel and the int8 GEMM
     (registers, spills, shared memory);
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
     the device's idle share over a tick;
 10. the attention dispatch by head width: bare 2-layer f32 encoders at
     Cohere's trunk widths (Dh 8: d 32, 4 heads; Dh 160: d 1280, 8 heads)
     and v3's (Dh 128) on the card against the CPU (relative L2 and one
     RelPosMHSA alone within 1e-4), with 0 kernel launches and one plain
     call per layer outside the kernel's range and one launch per layer
     inside it; the first request of a fresh v3 bf16 manager without and
     then with `warmup()`;
 11. the Parakeet facades and the CTC stack on the trained fixtures, on the
     card against the port on the CPU: `SlidingWindowAsrManager` and
     `StreamingUnifiedAsrManager` on the `asr` fixture (every update equal,
     no window error), `arbitrate` (the same strategy, confidences within
     1e-3), `MultiStreamEouManager` x3 on the `eou` fixture (token-exact
     ticks; a stream joining late and leaving early == the stream alone),
     and the `ctc` fixture's gates (greedy WER <= 0.02, beam agreement 1.0,
     spotting recall and precision >= 0.99, vocabulary boost corrected 1
     and false boost 0) with the card's canvas within 1e-4 of the CPU's;
 12. the slice at full width with seeded random weights: `CtcKeywordSpotter`
     at parakeet-ctc-0.6b width (24 x 1024, Dh 128, bf16) on 40 s, exactly
     24 attention launches per 15 s chunk and its canvas within 0.06 of the
     plain-attention canvas; `StreamingUnifiedAsrManager` on v3 at the
     640 ms and 2080 ms tiers in bf16 and the 2080 ms tier in int8,
     `SlidingWindowAsrManager` at its defaults and `arbitrate`, each path
     counted on its own; timing (card name and power limit on every line):
     the spotter's ms per chunk, the spotting DP for 20 terms, the greedy
     CTC decode, ms per window of each facade against its new audio with
     launches and idle share per window, and `arbitrate`;
 13. the registry on the card: with `checkpoint_dir=None` the trained `asr`,
     `ctc` and `eou` fixtures staged in a temporary offline model cache
     (`FLUID_CACHE_DIR`, `FLUID_OFFLINE=1`) under their registry folders
     load through `DownloadUtils.repo_dir` / `ensure_repo` and give what the
     explicit folders give (`AsrModels.load(allow_random_init=False)`, the
     keyword spotter, the EOU manager); an empty cache raises OfflineError;
 14. the trained `sensevoice`, `paraformer`, `cohere` and `vad` fixtures on
     the card against the port on the CPU: the same texts and WER, the same
     VAD F1, chunk probabilities within 1e-5, the same segments and
     streaming events; no kernel launched;
 15. SenseVoice Small, Paraformer-large, Cohere (48 x 1280, Dh 160) and
     Silero v5 at full width with seeded random weights drawn on the card:
     SenseVoice on a 30 s bucket and 75 s long-form, Paraformer on 20 s,
     Cohere on one window (34.99 s, the per-call cap) and two (64.98 s, one
     batch) with its decode steps and host syncs per batch of windows, Silero `process_batch` of
     64 x 60 s rows and 100 streaming 256 ms chunks; every path counted (0
     kernel launches; the Cohere encoder's 48 layers take the plain
     attention, 48 calls per encoder call); timing (card name and power limit on
     every line): ms per request (host wall, median after warm-up), RTFx,
     launches, idle share and peak memory; then full width at reduced depth
     in f32 (SenseVoice 2 + 2 SANM blocks, Paraformer 4 + 2, Cohere 4
     encoder + 2 decoder layers, Silero) on the card against the CPU:
     outputs within 1e-4 relative L2 (Silero 1e-5 abs) and tokens equal;
 16. diarization: the attention kernel against its plain version at
     Sortformer's shapes (SORTFORMER_V2: Dh 64, H 8; T 384 at B 16, the
     offline windows, and T 6 at B 1024, the streaming chunks), in f32 (tol
     1e-4) and bf16 (tol 0.06), timed beside its bound; the trained
     `offline` (offline and online managers) and `sortformer` fixtures on
     the card against the CPU (segments and DER equal, gates met, no kernel
     launched); at full width with seeded random weights drawn on the card,
     on 300 s of a 2-speaker mixture: `OfflineDiarizerManager()`,
     `DiarizerManager()` with each segmentation net, and Sortformer v2
     `process`, `process_offline` and 50 live `process_chunk` calls, each
     path counted (exactly 17 attention launches per Sortformer encoder
     call, 0 on the pyannote/WeSpeaker paths) and timed with its
     PipelineTimings stages; then full width at reduced depth in f32 on the
     card against the CPU (segmentation logits of both nets, ResNet
     embeddings, Sortformer predictions within 1e-4 relative L2, binarised
     predictions equal away from the threshold);
 17. LS-EEND, ITN and Kokoro English TTS (no kernel of the port is on
     them: every count reads 0): the trained `lseend` fixture on the card
     against the CPU (DER, `process` segments and a session of ragged 1 s
     pushes equal) and the trained `tts` fixture (phonemes and frame counts
     equal; with the same source draws, and the generator reading the CPU
     run's source STFTs, durations, F0 and N, the audio program and the
     samples within 1e-4 relative L2, end to end the samples within 1e-1
     (the test's tolerance); the tones of words 0, 7 and 15; two
     `synthesize` calls `array_equal`); the ITN vectors of tests/test_native.py
     (parsed, not imported) against their expected strings; at full width
     with seeded random weights drawn on the card: `LSEENDDiarizer()`
     (4 x 256, 23 mels, context 7) on 300 s at 500 and 100 ms steps and a
     session of ragged 1 s pushes, and Kokoro-82M (`KokoroConfig()`, its
     `duration_proj` bias set so that durations average 2-3 frames per
     token) on ~64, ~256 and 510 phoneme tokens and an English text of
     two or more chunks, two calls on it `array_equal`; timing (card name
     and power limit on every line): ms per request and per step or push,
     RTFx, launches, device busy, idle share, peak memory and
     `KokoroStageTimings`; then Kokoro at full width with ALBERT cut to 2
     layers, card against CPU with the same draws (durations, d, t_en and
     audio within 1e-4 relative L2);
 18. the rest of TTS (no kernel of the port is on it: every count reads
     0): the trained `pocket` fixture on the card against the CPU with the
     same frame noise (frame counts, done flags, samples, a `stream` and
     `clone_voice`: within 1e-4; the EOS logits' nearest approach to the
     threshold printed) and the trained `styletts2` fixture (style vectors,
     duration logits, F0/N and the acoustic program on the CPU's harmonic
     source within 1e-4, frame counts equal, end to end within 1e-1); the
     G2P decoders at G2P_BASE and ByT5-small (12 + 4 x 1472) on a batch of
     words, token ids equal to the CPU's; the g2pW BERT-base logits within
     1e-5 and `MandarinG2P` / Kokoro's mandarin variant over it on a Hanzi
     paragraph, bopomofo and phoneme ids equal; at full width with seeded
     random weights drawn on the card: StyleTTS2 (`STYLETTS2_BASE`,
     durations calibrated to 2-3 frames per token) on 64 and 256 tokens,
     PocketTTS (`POCKET_BASE`, EOS off: 250 frames, the frame step a CUDA
     graph) `synthesize`, `stream` per 25-frame block and `clone_voice`, and
     Supertonic-3 (`SUPERTONIC3_BASE`, 8 steps); timing (card name and
     power limit on every line): ms per request, RTFx, launches, device busy,
     idle share and peak memory; then the three at full width, reduced
     depth, card against CPU (within 1e-4 relative L2);
 19. the CLI (`fluidaudio_tpu_torch/cli/`), in-process through `main()`
     with each return code checked: `synthetic-guardrail` on the card over
     the thirteen sections the reference passes (`pins` included) with rc
     0 and every trained section's numbers equal to the port's CPU run of
     the same sections, then over `tts,pocket,styletts2` (the reference
     fails those gates at every commit) with rc 1, the CPU's failed gates
     and the CPU's numbers (the Kokoro and StyleTTS2 roundtrip WERs, whose
     audio follows the F0 track's last ulps, the CPU's gate outcome); `transcribe --version v3 --allow-random-init`
     on a 30 s file, its text that of `AsrManager.transcribe` on the card;
     `benchmark --workload all --batch 128` (its four metric lines);
     `streaming-latency-benchmark --chunks 16 --iters 1` at the three tiers;
     `diarize --mode sortformer --rttm` on 60 s, `tts-asr-verify
     --trained-fixture` and `normalize`; every command counted (the
     attention kernel once per layer of each encoder call whose head width
     it takes: 24 per v3 call, 17 per Sortformer v2 call; the plain version
     only at the widths it does not take; no int8 launch), profiled (all
     but the streaming probe, whose ~2 x 10^6 launches the profiler takes
     minutes to read) and timed (card name and power limit on every line);
 20. the checkpoint converters (`fluidaudio_tpu_torch/convert/`): a seeded
     full-width Parakeet v3 checkpoint in NeMo's key names (the NeMo oracle
     encoder's torch init on the card, the TDT prediction net and joint
     drawn beside it; ~0.62 B params), written with `torch.save` as a raw
     ckpt and converted by `convert_nemo_file` (seconds and GB/s printed);
     a test-tiny `.nemo` tar whose `model_config.yaml` adds a layer (applied
     where PyYAML is installed, the preset kept where it is not, as in JAX;
     the line says which), loaded on the card with every key consumed and
     held against the oracle on the CPU; the converted v3 through
     `AsrModels.load(checkpoint_dir=..., allow_random_init=False)` in bf16
     and int8 with every key consumed, three 15 s requests each through
     `AsrManager` (24 attention launches per encoder call, 265 int8
     launches per int8 call), one bf16 request profiled (launches, busy,
     idle share); the converted f32 encoder (the f32 attention kernel at Dh
     128, TF32 off) against the NeMo oracle (a copy of
     tests/test_conformer_nemo_parity.py's) on the raw weights on the card,
     15 s x 2 ragged, relative L2 <= 1e-4 over valid frames; a test-width
     Supertonic-3 ONNX release with no npz converted in place by
     `Supertonic3Manager`, which must hold the release's weights, and
     synthesized once.

The line before the last is the kernel record (JSON, with each kernel's
launches on its main path and on each path of phases 11-20, the plain
attention's calls on the paths that take it, bound and times); the last
line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
"""

from __future__ import annotations

import contextlib
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


def attention_cost(B: int, H: int, T: int, Dh: int, out_bytes: int, in_bytes: int = 2
                   ) -> tuple[int, int]:
    """(bytes, operations) of one relpos_attention call with every row full
    length: q.k, the shifted q.p band and P.V over every key; `in_bytes`
    per input element (bf16 by default), out in `out_bytes` per element,
    each read or written once."""
    nbytes = ((4 * B * H * T * Dh + H * (2 * T - 1) * Dh) * in_bytes + B * 4
              + B * H * T * Dh * out_bytes)
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


def phase_device(attn, i8) -> tuple[str, str]:
    from concurrent.futures import ThreadPoolExecutor

    from fluidaudio_tpu_torch.native import cxx, fastcluster, flac, itn, sysinfo
    from fluidaudio_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    with ThreadPoolExecutor(4) as pool:  # the host C/C++ builds beside the two nvcc
        flac_build = pool.submit(flac.build_library)
        fc_build = pool.submit(fastcluster.build_library)
        itn_build = pool.submit(itn.build_library)
        sysinfo_build = pool.submit(sysinfo.build_library)
        built = build.build(attn.KERNEL_SOURCE, i8.KERNEL_SOURCE)
        flac_lib, flac_s = flac_build.result()
        fc_lib, fc_s = fc_build.result()
        itn_lib, itn_s = itn_build.result()
        sysinfo_lib, sysinfo_s = sysinfo_build.result()
    compiler = subprocess.run([cxx.compiler(), "--version"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.splitlines()[0]
    attn_lib = attn.load_library()
    lib = i8.load_library()
    fastcluster.load_library()
    builds = " | ".join(f"{name} {sec:.2f} s" for name, (sec, _) in built.items())
    print(f"phase 1 device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| kernel builds (parallel nvcc): {builds} | host C++ ({compiler}, "
          f"{' '.join(cxx.CXX_FLAGS)}): FLAC decoder {flac_lib.name} {flac_s:.2f} s, "
          f"fastcluster {fc_lib.name} {fc_s:.2f} s, ITN {itn_lib.name} {itn_s:.2f} s | host C "
          f"({cxx.c_compiler()}, {' '.join(cxx.C_FLAGS)}): sysinfo {sysinfo_lib.name} "
          f"{sysinfo_s:.2f} s")
    report = ptxas_report(built[attn.KERNEL_SOURCE.name][1], "relpos_attention_wgmma")
    print(f"phase 1 relpos_attention_wgmma (nvcc -Xptxas -v): "
          f"{report or 'built before this run'} | dynamic shared memory "
          f"{attn_lib.relpos_attention_smem_bytes(64)} B (Dh <= 64), "
          f"{attn_lib.relpos_attention_smem_bytes(128)} B (Dh 80-128)")
    report = ptxas_report(built[i8.KERNEL_SOURCE.name][1], "int8_gemm_dequant")
    print(f"phase 1 int8_gemm_dequant (nvcc -Xptxas -v): {report or 'built before this run'} | "
          f"dynamic shared memory {lib.int8_gemm_dequant_smem_bytes()} B")
    return smi, builds


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
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    def manager(dev, quantization):
        models = AsrModels.load("test-tiny", checkpoint_dir=TRAINED_ASR, device=dev,
                                allow_random_init=False, quantization=quantization)
        return AsrManager(models, ASRConfig(parallel_chunk_batch=2))

    for quantization in ("none", "int8"):
        on_card, on_cpu = manager(device, quantization), manager("cpu", quantization)
        parts = []
        for ids, audio in fx.asr_fixture_utterances():  # the draws of eval_asr_fixture
            n = len(ids)
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


def v3_requests(attn, i8, device, quantization: str, version: str = "v3",
                checkpoint_dir: Path | None = None, seconds=(5.0, 15.0, 40.0)):
    """AsrModels.load (seeded random weights, or the npz of `checkpoint_dir`
    with every key required) -> AsrManager.transcribe at full width on
    requests of `seconds`, with every kernel count set to 0 just before the
    requests and read just after.
    -> (models, manager, {kernel: launches}, one line of results)."""
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.constants import ASRConstants
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.zoo import AsrModels

    int8 = quantization == "int8"
    t0 = time.perf_counter()
    models = AsrModels.load(version, checkpoint_dir=checkpoint_dir, device=device,
                            allow_random_init=checkpoint_dir is None, rng_seed=0,
                            quantization=quantization)
    manager = AsrManager(models, ASRConfig(parallel_chunk_batch=4))
    load_s = time.perf_counter() - t0
    n_layers = models.spec.conformer.n_layers
    vocab_out = models.spec.predictor.num_token_logits

    rs = np.random.RandomState(0)
    cal = np.stack([speechlike(rs, 15.0) for _ in range(16)])
    tps = calibrate_blank_bias(manager.build_pipeline(16), models, torch.from_numpy(cal),
                               torch.full((16,), WINDOW, dtype=torch.int32), 16 * 15.0)
    requests = [(f"{s:g}s" + (" chunked" if s * 16_000 > ASRConstants.MAX_MODEL_SAMPLES else ""),
                 speechlike(rs, s), None) for s in seconds]
    if int8:
        requests[1] = (requests[1][0] + " en", requests[1][1], "en")

    torch.cuda.synchronize()
    reset_launches(attn.relpos_attention, i8.int8_matmul_fused)
    attn.relpos_attention_plain.calls = 0
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
                "int8_matmul_fused": i8.int8_matmul_fused.launches,
                "relpos_attention_plain calls": attn.relpos_attention_plain.calls}
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
    """The draws of `eval_eou_fixture` (train/fixtures.eou_fixture_utterances):
    (reference text, audio followed by 1.28 s of open-mic silence)."""
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    return [(tc.transcript_text(ids), audio) for ids, audio in fx.eou_fixture_utterances(seed, n)]


def nemotron_fixture_utterances(seed: int = 9753, n: int = 6):
    """The draws of `eval_nemotron_fixture`: (language, reference, audio),
    alternating the fixture's two languages."""
    from fluidaudio_tpu_torch.train import fixtures as fx

    return fx.nemotron_fixture_utterances(seed, n)


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


def device_activity(prof) -> tuple[int, float]:
    """(kernel launches, device busy ms) of a CUDA profile, read from its raw
    events: the profiler's event tree (`prof.events()`) takes minutes to
    build at 10^5-10^6 launches."""
    spans, kernels = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != "CUDA":
            continue
        kernels += not e.name().startswith(("Memcpy", "Memset"))
        spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    total, end = 0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return kernels, total / 1e6


def profile_calls(fn, n: int) -> tuple[float, float]:
    """torch.profiler over n calls of fn, the device alone -> (kernel launches
    per call, device busy ms per call). Copies and memsets are busy time, not
    launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels, busy = device_activity(prof)
    check(busy > 0, "the profiler recorded no device time")
    return kernels / n, busy / n


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


# ------------------------------------------ repairs, facades and CTC phases


def counted(attn, i8, fn):
    """Run fn with every kernel count (and the plain attention's call count)
    set to 0 just before and read just after -> (fn's result, counts)."""
    torch.cuda.synchronize()
    reset_launches(attn.relpos_attention, i8.int8_matmul_fused)
    attn.relpos_attention_plain.calls = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {"relpos_attention": attn.relpos_attention.launches,
                 "int8_matmul_fused": i8.int8_matmul_fused.launches,
                 "relpos_attention_plain calls": attn.relpos_attention_plain.calls}


def host_ms(fn, runs: int = 5, warmup: int = 1) -> float:
    """Median host wall in ms of fn (ending in a device sync) after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


# bare encoders at the head widths of the attention dispatch, depth cut to 2
# layers: Cohere's trunk at its trained fixture (COHERE_TEST: d 32, 4 heads,
# 16 mels) and at full width (CohereConfig: d 1280, 8 heads, 160
# subsampling channels), and v3's width (Dh 128), all f32
DISPATCH_ENCODERS = [("Dh 8 (Cohere test trunk)", dict(n_mels=16, d_model=32, n_heads=4,
                                                       subsampling_channels=32)),
                     ("Dh 128 (v3 width)", dict(d_model=1024, n_heads=8)),
                     ("Dh 160 (Cohere full trunk)", dict(d_model=1280, n_heads=8,
                                                         subsampling_channels=160))]


def phase_repairs(attn, i8, device, build_s: str) -> None:
    """Phase 10: the attention dispatch by head width on the card against
    the CPU, and the first request of a fresh v3 manager with and without
    `warmup()`."""
    import copy

    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.conformer import (
        ConformerConfig, ConformerEncoder, rel_sinusoid)
    from fluidaudio_tpu_torch.models.zoo import AsrModels, disable_tf32, random_init_

    disable_tf32()  # true f32 on the card, as every entry point sets it
    parts = []
    for name, widths in DISPATCH_ENCODERS:
        cfg = ConformerConfig(n_layers=2, dtype="float32", **widths)
        cpu_enc = ConformerEncoder(cfg).eval()
        random_init_(cpu_enc, torch.Generator().manual_seed(0))
        with torch.no_grad():  # non-zero position biases
            for m in (cpu_enc.block0.mhsa, cpu_enc.block1.mhsa):
                m.pos_bias_u.normal_(0, 0.1)
                m.pos_bias_v.normal_(0, 0.1)
        card_enc = copy.deepcopy(cpu_enc).to(device)
        g = torch.Generator().manual_seed(1)
        mel = torch.randn(2, cfg.n_mels, 160, generator=g)
        mel_len = torch.tensor([160, 97], dtype=torch.int32)
        (got, got_len), counts = counted(attn, i8, lambda: card_enc(mel.to(device),
                                                                    mel_len.to(device)))
        want, _ = cpu_enc(mel, mel_len)
        rel = rel_l2(got.cpu(), want)
        # one block's attention alone, on the same input, valid rows
        T = got.shape[1]
        x = torch.randn(2, T, cfg.d_model, generator=g)
        pos = rel_sinusoid(T, cfg.d_model)
        with torch.no_grad():
            m_want = cpu_enc.block0.mhsa(x, pos, got_len.cpu())
            m_got = card_enc.block0.mhsa(x.to(device), pos.to(device), got_len)
        m_err = max((m_got[b, :n].cpu() - m_want[b, :n]).abs().max().item()
                    for b, n in enumerate(got_len.tolist()))
        in_range = attn.kernel_takes_head_dim(cfg.head_dim)
        want_launches = cfg.n_layers if in_range else 0
        check(counts["relpos_attention"] == want_launches
              and counts["relpos_attention_plain calls"] == cfg.n_layers - want_launches,
              f"{name}: counts {counts}, want {want_launches} kernel launches")
        check(rel <= 1e-4 and m_err <= 1e-4,
              f"{name}: card vs CPU relative L2 {rel}, attention alone max abs {m_err}")
        parts.append(f"{name}: {counts['relpos_attention']} kernel launches, "
                     f"{counts['relpos_attention_plain calls']} plain calls for "
                     f"{cfg.n_layers} layers | encoder card vs CPU rel L2 {rel:.2e}, "
                     f"RelPosMHSA alone max abs {m_err:.2e} (tol 1e-4)")
    print(f"phase 10 attention dispatch by head width (f32, 2 layers): {' | '.join(parts)}")

    rs = np.random.RandomState(10)
    audio = speechlike(rs, 15.0)
    lines = []
    for warm in (False, True):
        models = AsrModels.load("v3", device=device, rng_seed=0)
        manager = AsrManager(models, ASRConfig(parallel_chunk_batch=4))
        torch.cuda.synchronize()
        warm_s = 0.0
        if warm:
            t0 = time.perf_counter()
            manager.warmup()
            warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        manager.transcribe(audio)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        manager.transcribe(audio)
        torch.cuda.synchronize()
        second = time.perf_counter() - t0
        order = f"2nd manager, warmup() {warm_s:.3f} s, then" if warm else "1st manager, no warmup"
        lines.append(f"{order}: first 15 s request {first:.3f} s, second {second:.3f} s")
        del models, manager
        torch.cuda.empty_cache()
    print(f"phase 10 fresh v3 bf16 manager, in this order (the kernels were built in phase 1, "
          f"{build_s}, and are loaded in this process; neither run below pays for a build): "
          f"{' | '.join(lines)}")


def stream_updates(sliding, audio, piece: int):
    """Feed `audio` in pieces of `piece` samples -> (every update's fields,
    the final update's, the session)."""
    session = sliding.make_session()
    updates = []
    for start in range(0, audio.size, piece):
        updates += [vars(u) for u in sliding.feed(audio[start:start + piece], session)]
    final = vars(sliding.finish(session))
    check(session.error_count == 0, f"{session.error_count} windows failed")
    return updates, final, session


def ragged_schedule(m, audio, other):
    """A stream that joins late (slot 1 closed, then opened) and leaves early
    -> (the ticks' outputs, transcripts of slot 0 and the late stream)."""
    ticks = []
    m.streams[1].ended = True
    m.feed(0, other[:12_000])
    for _ in range(2):
        if m.ready:
            ticks.append(m.tick())
    late = m.open_stream()
    m.feed(late, audio[:8_000])
    m.feed(0, other[12_000:])
    while m.ready:
        ticks.append(m.tick())
    m.feed(late, audio[8_000:16_000])
    while m.ready:
        ticks.append(m.tick())
    m.end_stream(late)
    m.feed(0, other[:8_000])
    while m.ready:
        ticks.append(m.tick())
    return ticks, m.transcript(0), m.transcript(late)


def phase_facade_fixtures(attn, i8, device) -> dict:
    """Phase 11: the Parakeet facades and the CTC stack on the trained
    fixtures, on the card against the port on the CPU. -> {kernel: launches}."""
    from fluidaudio_tpu_torch.asr.arbitration import arbitrate
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.asr.multi_stream import MultiStreamEouManager
    from fluidaudio_tpu_torch.asr.sliding_window import (
        SlidingWindowAsrConfig, SlidingWindowAsrManager)
    from fluidaudio_tpu_torch.asr.streaming_eou import EOU_TEST
    from fluidaudio_tpu_torch.asr.unified import (
        StreamingUnifiedAsrManager, UnifiedStreamingConfig)
    from fluidaudio_tpu_torch.metrics.wer import wer
    from fluidaudio_tpu_torch.models.zoo import AsrModels
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    def asr_manager(dev):
        models = AsrModels.load("test-tiny", checkpoint_dir=TRAINED_ASR, device=dev,
                                allow_random_init=False)
        return AsrManager(models, ASRConfig(parallel_chunk_batch=2))

    def run():
        parts = []
        on_card, on_cpu = asr_manager(device), asr_manager("cpu")
        rs = np.random.RandomState(20)
        ids = rs.randint(0, tc.N_WORDS, size=24)
        audio = tc.make_utterance(ids, rs)
        window = dict(chunk_seconds=2.0, left_context_seconds=3.0, right_context_seconds=1.0)
        for label, make in (
                ("SlidingWindowAsrManager", lambda m: SlidingWindowAsrManager(
                    m, SlidingWindowAsrConfig(**window))),
                ("StreamingUnifiedAsrManager", lambda m: StreamingUnifiedAsrManager(
                    m.models, UnifiedStreamingConfig(**window)))):
            got, got_final, _ = stream_updates(make(on_card), audio, 5_000)
            want, want_final, _ = stream_updates(make(on_cpu), audio, 5_000)
            check(got == want and got_final == want_final,
                  f"{label} on the asr fixture: card updates differ from the CPU's")
            rate = wer(tc.transcript_text(ids), got_final["confirmed_text"]).rate
            parts.append(f"{label} {len(got)} updates == CPU, final WER {rate:.4f}")
        long_ids = rs.randint(0, tc.N_WORDS, size=40)
        long_audio = tc.make_utterance(long_ids, rs)
        got, want = arbitrate(on_card, long_audio), arbitrate(on_cpu, long_audio)
        worst = max(abs(got.confidences[k] - want.confidences[k]) for k in want.confidences)
        check(got.strategy == want.strategy and worst <= 1e-3,
              f"arbitrate: card {got} vs CPU {want}")
        parts.append(f"arbitrate picks {got.strategy!r} as the CPU, confidences within "
                     f"{worst:.2e} (tol 1e-3)")

        def multi(dev):
            return MultiStreamEouManager(3, 320, spec=EOU_TEST, checkpoint_dir=TRAINED_EOU,
                                         device=dev)

        utts = [a for _, a in eou_fixture_utterances(seed=31, n=3)]
        ticks = []
        for m in (multi(device), multi("cpu")):
            for i, a in enumerate(utts):
                m.feed(i, a[:len(a) // (i + 1)])
            out = []
            while m.ready:
                out.append(m.tick())
            for i, a in enumerate(utts):
                m.feed(i, a[len(a) // (i + 1):])
            while m.ready:
                out.append(m.tick())
            ticks.append((out, [m.transcript(i) for i in range(3)]))
        check(ticks[0] == ticks[1], "MultiStreamEouManager x3: card ticks differ from the CPU's")
        ragged = ragged_schedule(MultiStreamEouManager(2, 320, spec=EOU_TEST,
                                                       checkpoint_dir=TRAINED_EOU,
                                                       device=device), utts[0], utts[1])
        alone = MultiStreamEouManager(2, 320, spec=EOU_TEST, checkpoint_dir=TRAINED_EOU,
                                      device=device)
        alone.feed(0, utts[0][:16_000])
        while alone.ready:
            alone.tick()
        check(ragged[2] == alone.transcript(0) and ragged[2],
              f"late-joining stream {ragged[2]!r} != alone {alone.transcript(0)!r}")
        parts.append(f"MultiStreamEouManager x3 on the eou fixture: {len(ticks[0][0])} ticks "
                     f"token-exact against the CPU | a stream joining late and leaving early "
                     f"== the same stream alone ({ragged[2]!r})")

        ctc = fx.eval_ctc_fixture(device=device)
        spotting = fx.eval_ctc_spotting_fixture(device=device)
        boost = fx.eval_vocab_boost_fixture(device=device)
        check(ctc["wer_avg"] <= fx.ASR_WER_GATE and ctc["beam_agree_rate"] == 1.0,
              f"ctc fixture {ctc}")
        check(spotting["recall"] >= fx.KWS_RECALL_GATE
              and spotting["precision"] >= fx.KWS_PRECISION_GATE, f"spotting fixture {spotting}")
        check(boost["corrected"] == 1.0 and boost["false_boost"] == 0.0, f"boost fixture {boost}")
        terms = ["w0 w3", "w5", "w1 w2 w6"]
        card_spotter, _ = fx._ctc_spotter(terms, device=device)
        cpu_spotter, _ = fx._ctc_spotter(terms, device="cpu")
        rs = np.random.RandomState(13579)
        seq = rs.randint(0, tc.N_WORDS, size=40)
        spot_audio = tc.make_utterance(seq, rs)
        canvas_err = float(np.abs(card_spotter.log_probs(spot_audio)
                                  - cpu_spotter.log_probs(spot_audio)).max())
        check(canvas_err <= 1e-4, f"ctc canvas card vs CPU max abs {canvas_err}")
        parts.append(f"ctc fixture: greedy WER {ctc['wer_avg']:.4f}, beam agreement "
                     f"{ctc['beam_agree_rate']:.2f}, spotting recall {spotting['recall']:.2f} "
                     f"precision {spotting['precision']:.2f}, vocabulary boost corrected "
                     f"{boost['corrected']:.0f} false boost {boost['false_boost']:.0f}, canvas "
                     f"card vs CPU max abs {canvas_err:.2e} (tol 1e-4)")
        return parts

    parts, counts = counted(attn, i8, run)
    check(counts["relpos_attention"] > 0, "the fixture phase never launched the attention kernel")
    print(f"phase 11 trained fixtures on card vs the CPU port: {' | '.join(parts)} | "
          f"launches {counts}")
    return counts


# the parakeet-ctc-0.6b encoder: NeMo FastConformer 24 x 1024, 8 heads (Dh 128),
# CTC vocab 1024 + blank, bf16
CTC_0_6B = dict(d_model=1024, n_layers=24, n_heads=8)


def phase_spotter_full_width(attn, i8, device, smi: str) -> tuple[dict, dict]:
    """Phase 12a: CtcKeywordSpotter at parakeet-ctc-0.6b width with seeded
    random weights on 40 s (3 chunks): exactly 24 attention launches per
    chunk, the kernel's canvas against the same spotter's with plain
    attention; timing of a chunk, the spotting DP and the greedy decode.
    -> ({kernel: launches}, the timing numbers)."""
    from fluidaudio_tpu_torch.asr.custom_vocab.context import CustomVocabularyContext
    from fluidaudio_tpu_torch.asr.custom_vocab.ctc_spotter import spot_keywords
    from fluidaudio_tpu_torch.asr.keyword_spotter import (
        CHUNK_SAMPLES, CtcKeywordSpotter, KeywordSpotterConfig)
    from fluidaudio_tpu_torch.models import conformer as cf
    from fluidaudio_tpu_torch.models.conformer import ConformerConfig
    from fluidaudio_tpu_torch.ops.ctc_decode import ctc_greedy_decode

    cfg = ConformerConfig(**CTC_0_6B)
    spotter = CtcKeywordSpotter(CustomVocabularyContext([]), KeywordSpotterConfig(),
                                cfg, device=device)
    rs = np.random.RandomState(40)
    audio = speechlike(rs, 40.0)
    canvas, counts = counted(attn, i8, lambda: spotter.log_probs(audio))
    n_chunks = 3
    check(counts["relpos_attention"] == cfg.n_layers * n_chunks
          and counts["relpos_attention_plain calls"] == 0,
          f"spotter: {counts}, want {cfg.n_layers} x {n_chunks} kernel launches")
    check(canvas.shape[1] == 1025 and bool(np.isfinite(canvas).all()), "spotter canvas")
    cf.relpos_attention = attn.relpos_attention_plain  # the same spotter, plain attention
    try:
        plain = spotter.log_probs(audio)
    finally:
        cf.relpos_attention = attn.relpos_attention
    err = float(np.abs(canvas - plain).max())
    check(err <= PARITY_TOL, f"spotter canvas kernel vs plain attention max abs {err}")

    chunk = torch.from_numpy(audio[:CHUNK_SAMPLES])[None].to(device)
    full = torch.tensor([CHUNK_SAMPLES], dtype=torch.int32, device=device)
    chunk_ms = host_ms(lambda: spotter.chunk_log_probs(chunk, full).cpu())
    per_chunk, busy = profile_calls(lambda: spotter.chunk_log_probs(chunk, full).cpu(), 3)
    gen = np.random.RandomState(41)
    keywords = {f"term{i}": [int(t) for t in gen.randint(0, 1024, size=gen.randint(2, 7))]
                for i in range(20)}
    dp_ms = host_ms(lambda: spot_keywords(canvas, keywords, 1024), runs=3)
    lp = torch.from_numpy(canvas)[None].to(device)
    lens = torch.tensor([canvas.shape[0]], device=device)
    greedy_ms = host_ms(lambda: ctc_greedy_decode(lp, lens, 1024)[2].cpu(), runs=20)
    times = {"chunk_ms": chunk_ms, "dp_ms": dp_ms, "greedy_ms": greedy_ms}
    print(f"phase 12 CtcKeywordSpotter at parakeet-ctc-0.6b width ({cfg.n_layers}x{cfg.d_model}, "
          f"{cfg.n_heads} heads, Dh {cfg.head_dim}, vocab 1024 + blank, bf16, seeded random "
          f"weights), 40 s = {n_chunks} chunks: canvas {canvas.shape}, launches {counts} | "
          f"kernel canvas vs plain-attention canvas max abs {err:.3e} (tol {PARITY_TOL})")
    print(f"timing [{smi}] keyword spotter 15 s chunk (mel, encoder, head, log-softmax, one "
          f"copy back): median {chunk_ms:.3f} ms (host wall), {per_chunk:.0f} kernel launches "
          f"and {busy:.3f} ms device busy per chunk (profiler), idle share "
          f"{max(0.0, 1 - busy / chunk_ms):.3f} | spotting DP, 20 terms of 2-6 tokens over the "
          f"40 s canvas ({canvas.shape[0]} frames, host): median {dp_ms:.3f} ms | "
          f"ctc_greedy_decode on the card, [1, {canvas.shape[0]}, 1025]: median "
          f"{greedy_ms:.3f} ms (host wall incl. the copy of the counts)")
    del spotter
    torch.cuda.empty_cache()
    return counts, times


def time_facade(smi: str, label: str, sliding, cfg, audio) -> None:
    """Feed one window's new audio per call (after the first window), so each
    call runs one window (`cfg` is the manager's SlidingWindowAsrConfig):
    ms per window (host wall, median after 2 windows of warm-up) against the
    window's new audio; launches, device busy and idle share per window from
    the profiler over 3 more windows."""
    chunk_samples = cfg.chunk_samples
    session = sliding.make_session()
    first = cfg.chunk_samples + cfg.right_samples
    check(len(sliding.feed(audio[:first], session)) == 1, f"{label}: first window")
    pieces = [audio[s:s + chunk_samples] for s in range(first, audio.size, chunk_samples)]
    pieces = [p for p in pieces if p.size == chunk_samples]
    walls = []
    for i, piece in enumerate(pieces[:-3]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(len(sliding.feed(piece, session)) == 1, f"{label}: one window per call")
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    rest = iter(pieces[-3:])
    launches, busy = profile_calls(lambda: sliding.feed(next(rest), session), 3)
    final = sliding.finish(session)
    check(session.error_count == 0, f"{label}: {session.error_count} windows failed")
    ms = float(np.median(walls))
    new_ms = chunk_samples / 16
    print(f"timing [{smi}] {label}: {len(walls)} timed windows of {cfg.window_samples / 16_000:.2f} "
          f"s ({new_ms:.0f} ms new audio each): median {ms:.3f} ms per window, {ms / new_ms:.4f} "
          f"of the new audio | {launches:.0f} kernel launches and {busy:.3f} ms device busy per "
          f"window (profiler), idle share {max(0.0, 1 - busy / ms):.3f} | "
          f"{len(final.confirmed_text.split())} words confirmed")


def phase_facades_full_width(attn, i8, device, smi: str) -> dict:
    """Phase 12b: StreamingUnifiedAsrManager on v3 at the
    parakeet-unified-640ms and -2080ms tiers in bf16 and at -2080ms in int8,
    and SlidingWindowAsrManager at its defaults, over 30 s each; `arbitrate`
    on v3. Every path counted on its own. -> {path: {kernel: launches}}."""
    from fluidaudio_tpu_torch.asr.arbitration import arbitrate
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.asr.sliding_window import SlidingWindowAsrManager
    from fluidaudio_tpu_torch.asr.streaming_variants import create_streaming_manager
    from fluidaudio_tpu_torch.models.zoo import AsrModels

    rs = np.random.RandomState(30)
    audio = speechlike(rs, 30.0)
    out = {}
    blank_bias = None
    for quantization in ("none", "int8"):
        models = AsrModels.load("v3", device=device, rng_seed=0, quantization=quantization)
        joint_bias = models.joint.out.bias
        if blank_bias is None:
            cal = np.stack([speechlike(rs, 15.0) for _ in range(8)])
            calibrate_blank_bias(AsrManager(models).build_pipeline(8), models,
                                 torch.from_numpy(cal),
                                 torch.full((8,), WINDOW, dtype=torch.int32), 8 * 15.0)
            blank_bias = float(joint_bias[models.blank_id])
        else:  # the same seed: the int8 load's joint is the bf16 one's
            with torch.no_grad():
                joint_bias[models.blank_id] = blank_bias
        tiers = (("parakeet-unified-640ms", "parakeet-unified-2080ms") if quantization == "none"
                 else ("parakeet-unified-2080ms",))
        for key in tiers:
            mgr = create_streaming_manager(key, models=models, device=device)
            label = f"StreamingUnifiedAsrManager {key} v3 {quantization}"
            _, counts = counted(attn, i8, lambda: time_facade(
                smi, label, mgr, mgr._sliding.config, audio))
            want_int8 = quantization == "int8"
            check(counts["relpos_attention"] > 0
                  and (counts["int8_matmul_fused"] > 0) == want_int8
                  and counts["relpos_attention_plain calls"] == 0, f"{label}: {counts}")
            out[f"unified {key.split('-')[-1]} {quantization}"] = counts
        if quantization == "none":
            sliding = SlidingWindowAsrManager(AsrManager(models))
            label = "SlidingWindowAsrManager defaults (3 s + 10 s left + 2 s right) v3 none"
            _, counts = counted(attn, i8, lambda: time_facade(
                smi, label, sliding, sliding.config, audio))
            check(counts["relpos_attention"] > 0 and counts["int8_matmul_fused"] == 0, label)
            out["sliding defaults none"] = counts
            manager = AsrManager(models, ASRConfig())
            decision, counts = counted(attn, i8, lambda: arbitrate(manager, audio))
            check(counts["relpos_attention"] == models.spec.conformer.n_layers, f"arbitrate {counts}")
            out["arbitrate none"] = counts
            arb_ms = host_ms(lambda: arbitrate(manager, audio), runs=5)
            print(f"timing [{smi}] arbitrate on v3 bf16 (3 probes of 15 s in one "
                  f"build_pipeline(4) call): median {arb_ms:.3f} ms, picks "
                  f"{decision.strategy!r} (confidences "
                  + ", ".join(f"{k} {c:.4f}" for k, c in decision.confidences.items()) + ")")
        del models
        torch.cuda.empty_cache()
    print(f"phase 12 Parakeet facades at full width (v3 24 x 1024, seeded random weights, 30 s "
          f"of speech-like audio each): launches per path {out}")
    return out


# ------------------------------------- registry, SenseVoice, Paraformer, Cohere, VAD

TRAINED_CTC = TRAINED / "ctc"
# card against CPU at full width: encoder outputs in relative L2 (true f32 on both)
FAMILY_CARD_TOL = 1e-4
VAD_PROB_TOL = 1e-5
VAD_ROWS, VAD_ROW_S = 64, 60.0  # the Silero batch of phase 15
COHERE_ALONE = 4  # windows of the full Cohere batch also decoded alone


def peak_gib(fn):
    """fn's result and the peak device memory it allocated, in GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**30


def fixture_utterances(seed: int, n: int, max_words: int):
    """(transcript, audio) draws of the family fixture evaluations."""
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, max_words)))
        out.append((tc.transcript_text(ids), tc.make_utterance(ids, rs)))
    return out


class model_cache:
    """A temporary offline model cache (`FLUID_CACHE_DIR`, `FLUID_OFFLINE=1`)
    holding copies of trained fixtures under their registry folders."""

    def __init__(self, fixtures: dict):
        import tempfile

        self.tmp = tempfile.TemporaryDirectory()
        self.fixtures = fixtures

    def __enter__(self):
        import os
        import shutil

        self.saved = {k: os.environ.get(k) for k in ("FLUID_CACHE_DIR", "FLUID_OFFLINE")}
        os.environ["FLUID_CACHE_DIR"] = self.tmp.name
        os.environ["FLUID_OFFLINE"] = "1"
        for repo, src in self.fixtures.items():
            shutil.copytree(src, Path(self.tmp.name) / "Models" / repo.folder_name)
        return self

    def __exit__(self, *exc):
        import os

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        self.tmp.cleanup()


def phase_registry(attn, i8, device) -> dict:
    """Phase 13: checkpoint_dir=None resolves through the model cache on the
    card: `AsrModels.load("test-tiny", allow_random_init=False)`, the
    keyword spotter and the EOU manager from a cache holding the trained
    `asr`, `ctc` and `eou` fixtures give what the explicit folders give; an
    empty offline cache raises OfflineError. -> launches on this path."""
    from fluidaudio_tpu_torch.asr import streaming_eou as eou
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.custom_vocab.context import (
        CustomVocabularyContext, VocabularyTerm)
    from fluidaudio_tpu_torch.asr.keyword_spotter import CtcKeywordSpotter, KeywordSpotterConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.asr.tokenizer import Tokenizer
    from fluidaudio_tpu_torch.models.zoo import AsrModels
    from fluidaudio_tpu_torch.registry import OfflineError, Repo
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    utts = fixture_utterances(12345, 3, 12)
    tail = np.zeros(int(1.3 * 16_000), np.float32)
    terms = ["w0 w3", "w5", "w11"]

    def run_all(ckpt):
        models = AsrModels.load("test-tiny", checkpoint_dir=ckpt and TRAINED_ASR,
                                allow_random_init=False, device=device)
        asr = AsrManager(models, ASRConfig(parallel_chunk_batch=2))
        spotter = CtcKeywordSpotter(
            CustomVocabularyContext([VocabularyTerm(text=t) for t in terms],
                                    Tokenizer.from_json(TRAINED_CTC / "vocab.json"),
                                    min_term_length=2),
            KeywordSpotterConfig(vocab_size=tc.N_WORDS), fx.ctc_tiny_enc_cfg(),
            checkpoint_dir=ckpt and TRAINED_CTC, device=device)
        stream = eou.StreamingEouAsrManager(chunk_ms=320, spec=eou.EOU_TEST,
                                            checkpoint_dir=ckpt and TRAINED_EOU, device=device)
        out = []
        for _, audio in utts:
            state = stream.make_state()
            stream.process(np.concatenate([audio, tail]), state)
            out.append((asr.transcribe(audio).text, stream.finish(state).text,
                        sorted((s.keyword, s.start_frame, s.end_frame)
                               for s in spotter.spot(audio))))
        return out

    with model_cache({Repo.PARAKEET_V3: TRAINED_ASR, Repo.PARAKEET_CTC_0_6B: TRAINED_CTC,
                      Repo.PARAKEET_EOU: TRAINED_EOU}):
        cached, counts = counted(attn, i8, lambda: run_all(None))
    explicit = run_all(True)
    check(cached == explicit, f"model cache vs explicit folders: {cached} != {explicit}")
    check(all(a == t and e == t for (t, _), (a, e, _) in zip(utts, cached)),
          "registry: the cached fixtures' texts are not the transcripts")
    with model_cache({}):
        try:
            AsrModels.load("test-tiny", allow_random_init=False, device=device)
        except OfflineError as exc:
            raised = str(exc)
        else:
            raised = ""
    check("encoder.npz" in raised, f"empty offline cache: no OfflineError ({raised!r})")
    print(f"phase 13 registry on the card: checkpoint_dir=None from a temporary model cache "
          f"(parakeet-v3 <- asr, parakeet-ctc-0.6b <- ctc, parakeet-eou <- eou) == the explicit "
          f"folders for AsrModels.load(allow_random_init=False), CtcKeywordSpotter and "
          f"StreamingEouAsrManager on {len(utts)} utterances (every text the transcript) | empty "
          f"offline cache -> OfflineError | launches {counts}")
    return counts


def family_fixture_runs(device):
    """The four trained family fixtures through the port's managers on
    `device`: texts, WERs, VAD F1, chunk probabilities, segments and
    streaming events."""
    from fluidaudio_tpu_torch.asr.cohere_manager import CoherePipeline
    from fluidaudio_tpu_torch.asr.paraformer_manager import ParaformerManager
    from fluidaudio_tpu_torch.asr.sensevoice_manager import SenseVoiceManager
    from fluidaudio_tpu_torch.models.paraformer import PARAFORMER_TEST
    from fluidaudio_tpu_torch.models.sensevoice import SENSEVOICE_TEST
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.vad import VadManager, VadSegmentationConfig

    out = {}
    for name, make, seed, max_words, evaluate in (
            ("sensevoice", lambda: SenseVoiceManager(
                SENSEVOICE_TEST, checkpoint_dir=TRAINED / "sensevoice", device=device),
             321, 9, fx.eval_sensevoice_fixture),
            ("paraformer", lambda: ParaformerManager(
                PARAFORMER_TEST, checkpoint_dir=TRAINED / "paraformer", device=device),
             654, 9, fx.eval_paraformer_fixture),
            ("cohere", lambda: CoherePipeline(
                fx.cohere_tiny_config(), checkpoint_dir=TRAINED / "cohere", device=device),
             987, 8, fx.eval_cohere_fixture)):
        mgr = make()
        texts = [mgr.transcribe(a).text for _, a in fixture_utterances(seed, 6, max_words)]
        out[name] = (texts, evaluate(device=device))
    vad = VadManager(checkpoint_dir=TRAINED / "vad", device=device)
    clips = [c for _, c in fx.vad_fixture_clips()]
    probs = [np.array([r.probability for r in vad.process(c)]) for c in clips]
    batch = [np.array([r.probability for r in rs]) for rs in vad.process_batch(clips)]
    long = np.concatenate(clips)
    seg = VadSegmentationConfig(min_speech_duration=0.2, min_silence_duration=0.3)
    segments = [(s.start_time, s.end_time) for s in vad.segment_speech(long, seg)]
    state, events = vad.make_stream_state(), []
    for start in range(0, long.size, 4096):
        res = vad.process_streaming_chunk(long[start:start + 4096], state,
                                          VadSegmentationConfig(min_silence_duration=0.3))
        state = res.state
        if res.event is not None:
            events.append((res.event.kind, res.event.sample_index))
    out["vad"] = (fx.eval_vad_fixture(device=device), probs, batch, segments, events)
    return out


def phase_family_fixtures(attn, i8, device) -> dict:
    """Phase 14: the trained sensevoice, paraformer, cohere and vad fixtures
    on the card against the port on the CPU. -> launches per path."""
    out, c = counted(attn, i8, lambda: family_fixture_runs(device))
    cpu = family_fixture_runs("cpu")
    parts = []
    for name in ("sensevoice", "paraformer", "cohere"):
        (texts, rate), (cpu_texts, cpu_rate) = out[name], cpu[name]
        check(texts == cpu_texts and rate == cpu_rate,
              f"{name}: card texts/WER differ from the CPU ({rate} vs {cpu_rate})")
        check(rate <= 0.05, f"{name} fixture WER {rate}")
        parts.append(f"{name} WER {rate:.4f} (6 utterances, same texts as CPU)")
    f1, probs, batch, segments, events = out["vad"]
    c_f1, c_probs, c_batch, c_segments, c_events = cpu["vad"]
    err = max(float(np.abs(a - b).max()) for a, b in zip(probs + batch, c_probs + c_batch))
    check(f1 == c_f1 and f1 >= 0.9, f"vad F1 {f1} vs CPU {c_f1}")
    check(err <= VAD_PROB_TOL, f"vad chunk probabilities card vs CPU max abs {err}")
    check(segments == c_segments and events == c_events and segments and events,
          "vad segments or streaming events differ from the CPU")
    check(c["relpos_attention"] == 0 and c["int8_matmul_fused"] == 0,
          f"family fixtures launched a kernel: {c}")
    print(f"phase 14 trained family fixtures on the card vs the CPU port: {' | '.join(parts)} "
          f"| vad F1 {f1:.4f} (= CPU), chunk probabilities max abs {err:.2e} (tol "
          f"{VAD_PROB_TOL}, process and process_batch), {len(segments)} segments and "
          f"{len(events)} streaming events equal | launches {c} (the cohere encoder's 2 Dh-8 "
          f"layers take the plain attention)")
    return {"family fixtures (phase 14)": c}


def reduced_depth_parity(device) -> str:
    """Full width, reduced depth, f32, seeded random weights drawn on the
    card and copied to the CPU: SenseVoice (2 + 2 SANM blocks), Paraformer
    (4 encoder + 2 decoder blocks), Cohere (4 encoder + 2 decoder layers),
    Silero; the card's outputs against the CPU's."""
    from dataclasses import replace

    from fluidaudio_tpu_torch.models import cohere_asr as co
    from fluidaudio_tpu_torch.models import paraformer as pf
    from fluidaudio_tpu_torch.models import sensevoice as sv
    from fluidaudio_tpu_torch.models import silero_vad as sil
    from fluidaudio_tpu_torch.models.zoo import random_init_
    from fluidaudio_tpu_torch.ops.ctc_decode import ctc_greedy_decode

    def pair(make, seed):
        on_card = make(device).eval()
        random_init_(on_card, torch.Generator(device=device).manual_seed(seed))
        on_cpu = make("cpu").eval()
        on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
        return on_card, on_cpu

    def both(fn, *arrays):
        return [fn(dev, *[torch.from_numpy(a).to(dev) for a in arrays])
                for dev in (device, "cpu")]

    rs = np.random.RandomState(15)
    parts = []
    scfg = replace(sv.SENSEVOICE_SMALL, n_layers=2, tp_blocks=2, dtype="float32")
    enc = pair(lambda d: sv.SenseVoiceEncoder(scfg, device=d), 1)
    lfr = rs.randn(1, 500, 560).astype(np.float32)
    lp = both(lambda d, x, n, lang: enc[d == "cpu"](x, n, lang), lfr,
              np.array([480], np.int32), np.array([2], np.int32))
    err = rel_l2(lp[0].cpu(), lp[1])
    toks = [ctc_greedy_decode(x, torch.tensor([484], device=x.device), 0) for x in lp]
    same = all(torch.equal(a.cpu(), b) for a, b in zip(toks[0], toks[1]))
    check(err <= FAMILY_CARD_TOL and same, f"SenseVoice card vs CPU: rel L2 {err}, tokens {same}")
    parts.append(f"SenseVoice 4 SANM blocks x 512, 30 s: log-probs rel L2 {err:.2e}, "
                 f"CTC tokens equal ({int(toks[0][2][0])})")

    pcfg = replace(pf.PARAFORMER_LARGE, n_encoder_layers=4, n_decoder_layers=2, dtype="float32")
    model = pair(lambda d: pf.Paraformer(pcfg, device=d), 2)
    lfr = rs.randn(1, 334, 560).astype(np.float32)
    out = both(lambda d, x, n: model[d == "cpu"](x, n), lfr, np.array([334], np.int32))
    err = rel_l2(out[0][0].cpu(), out[1][0])
    same = (torch.equal(out[0][1].cpu(), out[1][1])
            and torch.equal(out[0][0].argmax(-1).cpu(), out[1][0].argmax(-1)))
    check(err <= FAMILY_CARD_TOL and same, f"Paraformer card vs CPU: rel L2 {err}, {same}")
    parts.append(f"Paraformer 4 enc + 2 dec x 512, 20 s: logits rel L2 {err:.2e}, CIF count "
                 f"{int(out[0][1][0])} and tokens equal")

    ccfg = replace(co.COHERE_BASE, n_encoder_layers=4, n_decoder_layers=2, dtype="float32")
    encoder = pair(lambda d: co.CohereEncoder(ccfg, device=d), 3)
    decoder = pair(lambda d: co.CohereDecoderStep(ccfg, device=d), 4)
    mel = rs.randn(1, 128, 3500).astype(np.float32)
    encs = both(lambda d, m, n: encoder[d == "cpu"](m, n), mel, np.array([3500], np.int32))
    err = rel_l2(encs[0][0].cpu(), encs[1][0])

    def decode(dec, e, m):
        cross = dec.cross_kv(e)
        return co.cohere_greedy_decode(
            ccfg, lambda t, p, k, v, e_, m_: dec(t, p, k, v, e_, m_, cross=cross), e, m)

    decs = [decode(dec, e, m) for (e, m), dec in zip(encs, decoder)]
    same = torch.equal(decs[0].tokens.cpu(), decs[1].tokens) and torch.equal(
        decs[0].counts.cpu(), decs[1].counts)
    check(err <= FAMILY_CARD_TOL and same, f"Cohere card vs CPU: rel L2 {err}, tokens {same}")
    # the same math per row: 4 windows in one batch against each alone, on the card
    mels = np.concatenate([mel, rs.randn(3, 128, 3500).astype(np.float32)])
    e4, m4 = encoder[0](torch.from_numpy(mels).to(device),
                        torch.full((4,), 3500, dtype=torch.int32, device=device))
    batch = decode(decoder[0], e4, m4)
    batch_err, rows_same = 0.0, 0
    for r in range(4):
        e1, m1 = encoder[0](torch.from_numpy(mels[r : r + 1]).to(device),
                            torch.tensor([3500], dtype=torch.int32, device=device))
        alone = decode(decoder[0], e1, m1)
        batch_err = max(batch_err, rel_l2(e4[r : r + 1], e1))
        rows_same += int(torch.equal(alone.tokens[0], batch.tokens[r])
                         and torch.equal(alone.counts[0], batch.counts[r]))
    check(batch_err <= FAMILY_CARD_TOL and rows_same == 4,
          f"Cohere batch of 4 vs alone: rel L2 {batch_err}, {rows_same}/4 rows equal")
    parts.append(f"Cohere 4 enc x 1280 (Dh 160) + 2 dec x 1024, 35 s: encoder rel L2 {err:.2e}, "
                 f"{int(decs[0].counts[0])} decoded tokens equal; a batch of 4 windows against "
                 f"each alone on the card: encoder rel L2 {batch_err:.2e}, {rows_same}/4 rows' "
                 f"tokens equal")

    vad = pair(lambda d: sil.SileroVadV5(device=d), 5)
    audio = (rs.randn(4, 64 + 64 * 512) * 0.1).astype(np.float32)
    zeros = np.zeros((4, 128), np.float32)
    res = both(lambda d, a, h, c, last: sil.vad_frame_program(vad[d == "cpu"], a, h, c, last),
               audio, zeros, zeros, np.array([63, 40, 5, 0], np.int32))
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(res[0], res[1]))
    check(err <= VAD_PROB_TOL, f"Silero card vs CPU max abs {err}")
    parts.append(f"Silero v5 frame program 4 x 64 frames: max abs {err:.2e}")
    return " | ".join(parts)


def time_request(smi: str, label: str, fn, audio_s: float, runs: int = 5,
                 per: tuple[int, str] | None = None) -> str:
    """Host wall per request (median after one warm-up; with `per` = (n,
    unit) also per unit), RTFx, launches, device busy and idle share
    (profiler) and peak memory over the timed runs."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = host_ms(fn, runs=runs, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches, busy = profile_calls(fn, 1)
    unit = f" ({ms / per[0]:.4f} ms per {per[1]}, {per[0]} of them)" if per else ""
    line = (f"timing [{smi}] {label}: median {ms:.3f} ms per request (host wall){unit}, RTFx "
            f"{audio_s / (ms / 1e3):.1f}, {launches:.0f} kernel launches and {busy:.3f} ms device "
            f"busy per request (profiler), idle share {max(0.0, 1 - busy / ms):.3f}, peak "
            f"{peak:.2f} GiB")
    print(line, flush=True)
    return line


def phase_families_full_width(attn, i8, device, smi: str) -> dict:
    """Phase 15: SenseVoice Small, Paraformer-large, Cohere (COHERE_BASE)
    and Silero v5 at full width with seeded random weights drawn on the
    card: each path counted, timed, and the reduced-depth card-vs-CPU
    parity. -> launches per path."""
    from fluidaudio_tpu_torch.asr.cohere_manager import CoherePipeline
    from fluidaudio_tpu_torch.asr.paraformer_manager import ParaformerManager
    from fluidaudio_tpu_torch.asr.sensevoice_manager import SenseVoiceManager
    from fluidaudio_tpu_torch.asr.cohere_manager import WINDOW_BATCH
    from fluidaudio_tpu_torch.vad import VadManager
    from fluidaudio_tpu_torch.vad.manager import PROGRAM_CACHE_SIZE

    rs = np.random.RandomState(150)
    paths = {}
    missing = Path(REPO / "_no_checkpoint")  # seeded random weights on the card

    def path(label, fn, want_plain=0, **expect):
        out, c = counted(attn, i8, fn)
        check(c["relpos_attention"] == 0 and c["int8_matmul_fused"] == 0
              and c["relpos_attention_plain calls"] == want_plain,
              f"{label}: launches {c}, want 0 kernel launches and {want_plain} plain calls")
        paths[label] = c
        return out

    sense = SenseVoiceManager(checkpoint_dir=missing, device=device)
    a30, a75 = speechlike(rs, 30.0), speechlike(rs, 75.0)
    r = path("SenseVoice Small, 30 s", lambda: sense.transcribe(a30))
    check(isinstance(r.text, str) and r.duration == 30.0, "SenseVoice 30 s result")
    r = path("SenseVoice Small, 75 s", lambda: sense.transcribe(a75))
    check(r.duration == 75.0, "SenseVoice 75 s result")
    time_request(smi, "SenseVoice Small (50 + 20 SANM x 512, vocab 25,055, bf16), 30 s bucket",
                 lambda: sense.transcribe(a30), 30.0)
    time_request(smi, "SenseVoice Small, 75 s long-form (30 + 30 + 15 s windows)",
                 lambda: sense.transcribe(a75), 75.0, runs=3)
    del sense

    para = ParaformerManager(checkpoint_dir=missing, device=device)
    a20 = speechlike(rs, 20.0)
    path("Paraformer-large, 20 s", lambda: para.transcribe(a20))
    time_request(smi, "Paraformer-large (50 enc + 16 dec SANM x 512, vocab 8,404, 128 tokens, "
                 "bf16), 20 s", lambda: para.transcribe(a20), 20.0)
    del para
    torch.cuda.empty_cache()

    cohere, load_gib = peak_gib(lambda: CoherePipeline(checkpoint_dir=missing, device=device))
    n_layers = cohere.cfg.n_encoder_layers
    # the per-call cap is (max_audio_frames - 1) hops = 34.99 s, the hop 29.99 s:
    # the longest inputs of one and of two windows
    cap = (cohere.cfg.max_audio_frames - 1) * 160
    one_s, two_s = cap / 16_000, (2 * cap - 80_000) / 16_000
    a_one, a_two = speechlike(rs, one_s), speechlike(rs, two_s)
    path(f"Cohere, {one_s:.2f} s (one window)", lambda: cohere.transcribe(a_one),
         want_plain=n_layers)
    one = (cohere.window_count, [(w.steps, w.host_syncs) for w in cohere.window_decodes])
    # the two windows run as one batch: one encoder call (48 plain calls)
    path(f"Cohere, {two_s:.2f} s (two windows)", lambda: cohere.transcribe(a_two),
         want_plain=n_layers)
    two = (cohere.window_count, [(w.steps, w.host_syncs) for w in cohere.window_decodes])
    check(one[0] == 1 and two[0] == 2 and len(two[1]) == 1, f"Cohere windows {one} {two}")
    print(f"phase 15 Cohere (48 x 1280 conformer, Dh 160 -> plain attention, 8 x 1024 decoder, "
          f"vocab 16,384, 108 tokens, bf16, weights {load_gib:.2f} GiB): (windows, [(decode "
          f"steps, host syncs) per batch of windows]): {one_s:.2f} s {one}, {two_s:.2f} s {two}")
    time_request(smi, f"Cohere, {one_s:.2f} s window", lambda: cohere.transcribe(a_one), one_s,
                 runs=3)
    time_request(smi, f"Cohere, {two_s:.2f} s long-form (2 windows, 5 s overlap, one batch)",
                 lambda: cohere.transcribe(a_two), two_s, runs=3)
    # a long input that fills one batch of WINDOW_BATCH windows, the first
    # COHERE_ALONE of them then decoded alone: bf16 GEMMs at batch 16 and at
    # batch 1 need not round alike, so the agreement is recorded, not required
    hop = cap - 80_000
    n_win = WINDOW_BATCH
    a_full = speechlike(rs, 1.0 + (cap + (n_win - 1) * hop) / 16_000)[: cap + (n_win - 1) * hop]
    full_s = a_full.size / 16_000
    path(f"Cohere, {full_s:.2f} s ({n_win} windows)", lambda: cohere.transcribe(a_full),
         want_plain=n_layers)
    check(cohere.window_count == n_win and len(cohere.window_decodes) == 1,
          f"Cohere {full_s:.2f} s: {cohere.window_count} windows in "
          f"{len(cohere.window_decodes)} batches")
    batch = cohere.window_decodes[0]
    same, first_diff = 0, []
    for w in range(COHERE_ALONE):
        seg = torch.from_numpy(a_full[w * hop : w * hop + cap]).to(device)[None]
        alone = cohere.run_window(seg, torch.tensor([cap], dtype=torch.int32, device=device))
        n = int(alone.counts[0])
        if n == int(batch.counts[w]) and torch.equal(alone.tokens[0, :n], batch.tokens[w, :n]):
            same += 1
        else:
            diff = (alone.tokens[0] != batch.tokens[w]).nonzero()
            first_diff.append((w, int(diff[0]) if diff.numel() else n))
    print(f"phase 15 Cohere, {n_win} windows in one batch, the first {COHERE_ALONE} against "
          f"each window alone (bf16): {same}/{COHERE_ALONE} windows with equal tokens and "
          f"counts; (window, first differing position) {first_diff}; batch steps "
          f"{batch.steps}, host syncs {batch.host_syncs}")
    time_request(smi, f"Cohere, {full_s:.2f} s long-form ({n_win} windows, one batch)",
                 lambda: cohere.transcribe(a_full), full_s, runs=1)
    del cohere
    torch.cuda.empty_cache()

    vad = VadManager(checkpoint_dir=missing, device=device)
    rows = [speechlike(rs, VAD_ROW_S) for _ in range(VAD_ROWS)]
    chunks = -(-int(VAD_ROW_S * 16_000) // 4096)
    frames = (1 << (chunks - 1).bit_length()) * 8  # the power-of-two bucket, 8 frames a chunk
    label = f"Silero process_batch {VAD_ROWS} x {VAD_ROW_S:.0f} s"
    res = path(label, lambda: vad.process_batch(rows))
    check(len(res) == VAD_ROWS and all(len(r) == chunks for r in res)
          and all(0.0 <= x.probability <= 1.0 for r in res for x in r), "Silero batch results")
    line = time_request(smi, f"Silero v5 {label[7:]} (one bucket of {frames} frames, CUDA graph "
                        "per (batch, bucket))", lambda: vad.process_batch(rows),
                        VAD_ROWS * VAD_ROW_S)
    ms = float(re.search(r"median ([0-9.]+) ms", line).group(1))
    # the frame program alone (its CUDA graph replay), against the whole call
    prog = vad._frame_program(VAD_ROWS, frames, np.float32)
    g = torch.Generator(device=device).manual_seed(151)
    audio_t = torch.randn(VAD_ROWS, 64 + frames * 512, generator=g, device=device) * 0.1
    h0 = torch.zeros(VAD_ROWS, 128, device=device)
    last = torch.full((VAD_ROWS,), frames - 1, dtype=torch.int32, device=device)
    prog_ms = cuda_ms(lambda: prog(audio_t, h0, h0, last), iters=5)
    print(f"timing [{smi}] Silero batch: the frame program alone {prog_ms:.3f} ms (CUDA events), "
          f"{prog_ms / frames:.4f} ms per frame step of the recurrence ({VAD_ROWS} rows x 32 ms "
          f"each); the rest of the {ms:.3f} ms call is host packing and results")
    stream = speechlike(rs, 100 * 0.256)

    def hundred_chunks():
        state = vad.make_stream_state()
        for i in range(100):
            state = vad.process_streaming_chunk(stream[i * 4096:(i + 1) * 4096], state).state
        return state

    path("Silero streaming, 100 x 256 ms chunks", hundred_chunks)
    line = time_request(smi, "Silero v5 streaming, 100 chunks of 256 ms (8 frames each, one "
                        "call per chunk)", hundred_chunks, 25.6, runs=3)
    ms = float(re.search(r"median ([0-9.]+) ms", line).group(1))
    print(f"timing [{smi}] Silero streaming: {ms / 100:.3f} ms per 256 ms chunk, "
          f"{ms / 800:.4f} ms per frame")
    # more (batch, bucket) shapes than the manager keeps: the device memory
    # its CUDA graphs hold, after each new shape
    torch.cuda.synchronize()
    held = [f"before {torch.cuda.memory_reserved() / 2**30:.3f}"]
    for b, secs in ((32, 60.0), (64, 30.0), (16, 60.0), (64, 15.0), (8, 60.0), (48, 45.0),
                    (64, 8.0), (4, 60.0), (24, 20.0), (64, 60.0)):
        vad.process_batch([r[: int(secs * 16_000)] for r in rows[:b]])
        torch.cuda.synchronize()
        held.append(f"{b}x{secs:.0f}s {torch.cuda.memory_reserved() / 2**30:.3f}")
    programs = list(vad._program_cache.values())
    check(len(programs) <= PROGRAM_CACHE_SIZE
          and all(p.pool is vad._graph_pool and p.stream is vad._warmup_stream
                  and p.graph is not None for p in programs),
          f"Silero graphs: {len(programs)} kept, pools shared "
          f"{[p.pool is vad._graph_pool for p in programs]}")
    print(f"phase 15 Silero graph memory [{smi}]: torch.cuda.memory_reserved GiB after each new "
          f"(rows x seconds) shape: {', '.join(held)}; {len(programs)} programs kept (limit "
          f"{PROGRAM_CACHE_SIZE}, one shared pool and warm-up stream), "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    del vad
    torch.cuda.empty_cache()

    print(f"phase 15 full width, reduced depth, f32, card vs CPU (tol {FAMILY_CARD_TOL} rel L2): "
          f"{reduced_depth_parity(device)}")
    return paths


# ------------------------------------------------------------- phase 16

# the attention kernel at Sortformer's shapes (SORTFORMER_V2: 8 heads, Dh 64):
# the offline 30.72 s windows (T 384, a bucket of 16) and the streaming
# chunks (T 6, a bucket of 1024 chunks: a 300 s recording's 625 chunks)
SORTFORMER_ATTN_SHAPES = [(16, 8, 384, 64), (1024, 8, 6, 64)]
# f32 in (the config's dtype: the kernel's SIMT path) against the plain
# version in f32: the same math in another order
SF_F32_TOL = 1e-4
F32_FLOPS = 67e12  # float32 outside the tensor cores (data sheet, dense)
DIAR_SECONDS = 300.0
SF_LIVE_CHUNKS = 50
SF_ENCODER_LAYERS = 17  # SORTFORMER_V2: one attention launch per layer per encoder call


def sortformer_attention(attn, device, smi: str) -> tuple[float, list[str]]:
    """The attention kernel against its plain version at Sortformer's
    shapes, in f32 and bf16, in the encoder's call form (strided views,
    `out=` in the input dtype), and timed beside its bound. -> (max abs
    error, lines)."""
    worst, lines = 0.0, []
    for B, H, T, Dh in SORTFORMER_ATTN_SHAPES:
        lens = torch.full((B,), T, dtype=torch.int32, device=device)
        for dtype, tol, peak in ((torch.float32, SF_F32_TOL, F32_FLOPS),
                                 (torch.bfloat16, PARITY_TOL, BF16_FLOPS)):
            qu, qw, k, v, p = attention_inputs(B, H, T, Dh, dtype, device, seed=16,
                                               strided=True)
            out = torch.empty(B, T, H, Dh, dtype=dtype, device=device).transpose(1, 2)
            kernel = lambda: attn.relpos_attention(qu, qw, k, v, p, lens, T, out=out)
            plain = lambda: attn.relpos_attention_plain(qu, qw, k, v, p, lens, T)
            got = kernel().float()
            err = float((got - plain()).abs().max())
            check(err <= tol, f"relpos_attention B={B} T={T} Dh={Dh} {dtype}: err {err} > {tol}")
            worst = max(worst, err) if dtype == torch.bfloat16 else worst
            p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
            size = 4 if dtype == torch.float32 else 2
            nbytes, ops = attention_cost(B, H, T, Dh, size, size)
            bound_ms, bound_by = bound(nbytes, ops, peak)
            name = "f32" if dtype == torch.float32 else "bf16"
            line = (f"timing [{smi}] relpos_attention B={B} H={H} T={T} Dh={Dh} {name} "
                    f"(encoder form): kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
                    f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e6:.1f} MB, peak "
                    f"{peak / 1e12:.0f} TFLOP/s), {bound_ms / min(k1, k2):.1%} of it; "
                    f"max abs err {err:.2e} (tol {tol})")
            print(line, flush=True)
            lines.append(line)
    return worst, lines


def diarizer_fixture_runs(device) -> dict:
    """The trained `offline` (offline and online managers) and `sortformer`
    fixtures on `device`: segments and DER of each fixture evaluation."""
    from fluidaudio_tpu_torch.diarizer.sortformer import SortformerDiarizer
    from fluidaudio_tpu_torch.models.sortformer import SORTFORMER_TEST
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    def segs(result):
        return [(s.speaker_id, round(s.start_time, 6), round(s.end_time, 6))
                for s in result.segments]

    mix = lambda seed: tc.diarizer_mixture(np.random.RandomState(seed), 60.0)[0]
    sf = SortformerDiarizer(SORTFORMER_TEST, checkpoint_dir=TRAINED / "sortformer", device=device)
    return {
        "offline": (segs(fx.offline_diarizer_manager(device=device).process(mix(13579))),
                    fx.eval_offline_diarizer_fixture(device=device)),
        "online": (segs(fx.online_diarizer_manager(device=device).process(mix(97531))),
                   fx.eval_online_diarizer_fixture(device=device)["der"]),
        "sortformer offline": (segs(sf.process_offline(mix(4242))),
                               fx.eval_sortformer_fixture(device=device)),
        "sortformer streaming": (segs(sf.process(mix(4242))), None),
    }


def diarizer_reduced_depth_parity(device) -> str:
    """Full width, reduced depth, f32, seeded random weights drawn on the
    card and copied to the CPU: the pyannote attention net and PyanNet
    (logits), WeSpeaker ResNet (1 block per stage, embeddings), Sortformer
    (2 encoder + 2 transformer layers: offline window and 8 streaming
    chunks); the card's outputs against the CPU's, and the binarised
    Sortformer predictions equal wherever they are not within 1e-3 of the
    threshold."""
    from dataclasses import replace

    from fluidaudio_tpu_torch.diarizer.sortformer import OFFLINE_WINDOW_MEL, SortformerDiarizer
    from fluidaudio_tpu_torch.models import pyannote_seg as ps
    from fluidaudio_tpu_torch.models import wespeaker as ws
    from fluidaudio_tpu_torch.models.sortformer import SORTFORMER_V2
    from fluidaudio_tpu_torch.models.zoo import random_init_
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    def pair(make, seed):
        on_card = make(device).eval()
        random_init_(on_card, torch.Generator(device=device).manual_seed(seed))
        on_cpu = make("cpu").eval()
        on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
        return on_card, on_cpu

    rs = np.random.RandomState(16)
    mix = tc.diarizer_mixture(rs, 40.0, overlap_prob=0.2)[0]
    wav = np.stack([mix[:160_000], mix[160_000:320_000]])
    parts = []
    for label, make in (("attention segmentation", lambda d: ps.PyannoteSegmentation(device=d)),
                        ("PyanNet", lambda d: ps.PyanNet(device=d))):
        card, cpu = pair(make, 1)
        a, b = card(torch.from_numpy(wav).to(device)), cpu(torch.from_numpy(wav))
        err = rel_l2(a.cpu(), b)
        same = float((a.argmax(-1).cpu() == b.argmax(-1)).float().mean())
        check(err <= FAMILY_CARD_TOL, f"{label} card vs CPU rel L2 {err}")
        parts.append(f"{label} logits rel L2 {err:.2e} (argmax equal on {same:.4f} of frames)")

    card, cpu = pair(lambda d: ws.WeSpeakerEmbedder(ws.WeSpeakerConfig.tiny(), device=d), 2)
    fbank = ws.make_fbank_frontend("cpu")
    mel = fbank(torch.from_numpy(wav))[0].transpose(1, 2).contiguous()
    mask = torch.from_numpy((rs.rand(2, 589) > 0.3).astype(np.float32))
    a, b = card(mel.to(device), mask.to(device)), cpu(mel, mask)
    err = rel_l2(a.cpu(), b)
    check(err <= FAMILY_CARD_TOL, f"WeSpeaker card vs CPU rel L2 {err}")
    parts.append(f"WeSpeaker ResNet (1 block per stage, 32-256 ch) embeddings rel L2 {err:.2e}")

    cfg = replace(SORTFORMER_V2, n_encoder_layers=2, n_transformer_layers=2)
    card_d = SortformerDiarizer(cfg, device=device, checkpoint_dir=REPO / "no-checkpoint")
    cpu_d = SortformerDiarizer(cfg, device="cpu", checkpoint_dir=REPO / "no-checkpoint")
    cpu_d.model.load_state_dict({k: v.cpu() for k, v in card_d.model.state_dict().items()})
    window = OFFLINE_WINDOW_MEL * 160
    step = window - 64 * 1280
    flat = np.zeros(2 * step, np.float32)
    flat[: min(mix.size, flat.size)] = mix[: flat.size]
    chunks = mix[: 8 * cfg.chunk_frames * 1280].reshape(8, -1)
    for label, run in (
            ("offline window (T 384)",
             lambda d: d.offline_windows(torch.from_numpy(flat).to(d.device), 1, step, window)),
            ("8 streaming chunks (T 6)",
             lambda d: d.stream_program(torch.from_numpy(chunks).to(d.device), d.make_state())[0])):
        a, b = run(card_d).cpu(), run(cpu_d)
        err = rel_l2(a, b)
        firm = ((a - 0.5).abs() > 1e-3) & ((b - 0.5).abs() > 1e-3)
        same = bool(torch.equal((a >= 0.5)[firm], (b >= 0.5)[firm]))
        check(err <= FAMILY_CARD_TOL and same,
              f"Sortformer {label} card vs CPU: rel L2 {err}, binarised equal {same}")
        parts.append(f"Sortformer 2 enc x 512 + 2 tf x 192, {label}: preds rel L2 {err:.2e}, "
                     f"segments equal on {int(firm.sum())}/{firm.numel()} firm frames")
    return " | ".join(parts)


def time_diarizer(smi: str, label: str, fn, audio_s: float, runs: int = 2) -> str:
    """`time_request` (device-only profile), then the PipelineTimings stages
    of its last call."""
    last = {}
    line = time_request(smi, label, lambda: last.update(r=fn()), audio_s, runs=runs)
    t = last["r"].timings
    print(f"timing [{smi}] {label}: PipelineTimings segmentation "
          f"{t.segmentation_seconds * 1e3:.1f} ms, embedding {t.embedding_seconds * 1e3:.1f} ms, "
          f"clustering {t.clustering_seconds * 1e3:.1f} ms, post "
          f"{t.post_processing_seconds * 1e3:.1f} ms, total {t.total_seconds * 1e3:.1f} ms",
          flush=True)
    return line


def phase_diarizers(attn, i8, device, smi: str) -> tuple[dict, float, list[str]]:
    """Phase 16: the attention kernel at Sortformer's shapes; the trained
    diarizer fixtures on the card against the CPU; the offline, online and
    Sortformer diarizers at full width on 300 s, each path counted and
    timed; the reduced-depth card-vs-CPU parity. -> (launches per path,
    the kernel's max abs error at these shapes in bf16, timing lines)."""
    from fluidaudio_tpu_torch.diarizer.manager import DiarizerManager
    from fluidaudio_tpu_torch.diarizer.offline.manager import OfflineDiarizerManager
    from fluidaudio_tpu_torch.diarizer.sortformer import SortformerDiarizer
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    err, lines = sortformer_attention(attn, device, smi)
    print(f"phase 16 relpos_attention at Sortformer's shapes (Dh 64, H 8; T 384 at B 16 and "
          f"T 6 at B 1024), f32 (tol {SF_F32_TOL}) and bf16 (tol {PARITY_TOL}) against the "
          f"plain version: bf16 max abs err {err:.2e}", flush=True)

    out, c = counted(attn, i8, lambda: diarizer_fixture_runs(device))
    cpu = diarizer_fixture_runs("cpu")
    parts = []
    for name, (segments, der) in out.items():
        check(segments == cpu[name][0] and der == cpu[name][1],
              f"{name} fixture on the card: segments or DER differ from the CPU")
        parts.append(f"{name}: {len(segments)} segments"
                     + (f", DER {der:.4f}" if der is not None else "") + " (= CPU)")
    check(out["offline"][1] <= fx.DIAR_DER_GATE and out["online"][1] <= fx.ONLINE_DIAR_DER_GATE
          and out["sortformer offline"][1] <= fx.DIAR_DER_GATE, "a diarizer fixture fails its gate")
    check(c["relpos_attention"] == 0 and c["int8_matmul_fused"] == 0,
          f"diarizer fixtures launched a kernel: {c}")
    print(f"phase 16 trained diarizer fixtures on the card vs the CPU port: {' | '.join(parts)} "
          f"| launches {c} (the sortformer fixture's Dh-8 encoder takes the plain attention)",
          flush=True)
    paths = {"diarizer fixtures (phase 16)": c}

    audio = tc.diarizer_mixture(np.random.RandomState(300), DIAR_SECONDS, overlap_prob=0.1)[0]
    empty = REPO / "no-checkpoint"  # seeded random weights, drawn on the card
    # the online managers pad the last 10 s chunk, as JAX's do: a segment may
    # run to its end
    managers = [
        ("offline diarizer (attention seg + ResNet34 + PLDA/AHC/VBx)",
         OfflineDiarizerManager(checkpoint_dir=empty, device=device), 0.5),
        ("online diarizer (attention seg)", DiarizerManager(checkpoint_dir=empty, device=device),
         10.0),
        ("online diarizer (PyanNet seg)",
         DiarizerManager(checkpoint_dir=empty, segmentation_arch="pyannet", device=device), 10.0),
    ]
    for label, mgr, slack in managers:
        result, c = counted(attn, i8, lambda: mgr.process(audio))
        check(c["relpos_attention"] == 0 and c["int8_matmul_fused"] == 0,
              f"{label}: launches {c}")
        check(all(0 <= s.start_time < s.end_time <= DIAR_SECONDS + slack
                  for s in result.segments), f"{label}: a segment outside the recording")
        key = f"{label}, {DIAR_SECONDS:.0f} s"
        paths[key] = c
        lines.append(time_diarizer(smi, f"{key}: {len(result.segments)} segments, "
                                        f"{result.speaker_count} speakers, launches {c}",
                                   lambda: mgr.process(audio), DIAR_SECONDS))
    del managers
    torch.cuda.empty_cache()

    sf = SortformerDiarizer(checkpoint_dir=empty, device=device)
    for label, fn in (("process", sf.process), ("process_offline", sf.process_offline)):
        result, c = counted(attn, i8, lambda: fn(audio))
        check(c["relpos_attention"] == SF_ENCODER_LAYERS and c["int8_matmul_fused"] == 0
              and c["relpos_attention_plain calls"] == 0,
              f"sortformer {label}: launches {c}, want {SF_ENCODER_LAYERS} per encoder call")
        check(all(0 <= s.start_time < s.end_time <= DIAR_SECONDS + 0.5 for s in result.segments),
              f"sortformer {label}: a segment outside the recording")
        key = f"sortformer v2 {label}, {DIAR_SECONDS:.0f} s"
        paths[key] = c
        lines.append(time_diarizer(smi, f"{key}: {len(result.segments)} segments, launches {c} "
                                        f"(1 encoder call)", lambda: fn(audio), DIAR_SECONDS))
    chunk = sf.cfg.chunk_frames * 1280

    def live():
        state = sf.make_state()
        preds = []
        for i in range(SF_LIVE_CHUNKS):
            p, state = sf.process_chunk(audio[i * chunk : (i + 1) * chunk], state)
            preds.append(p)
        return np.concatenate(preds)

    preds, c = counted(attn, i8, live)
    check(c["relpos_attention"] == SF_ENCODER_LAYERS * SF_LIVE_CHUNKS
          and np.isfinite(preds).all() and preds.shape == (SF_LIVE_CHUNKS * 6, 4),
          f"sortformer live chunks: launches {c}, preds {preds.shape}")
    key = f"sortformer v2 process_chunk x{SF_LIVE_CHUNKS} (live)"
    paths[key] = c
    ms = host_ms(live, runs=2)
    launches, busy = profile_calls(live, 1)
    line = (f"timing [{smi}] {key}: {ms / SF_LIVE_CHUNKS:.3f} ms per 480 ms chunk (host wall, "
            f"median of 2 runs of {SF_LIVE_CHUNKS}), {launches / SF_LIVE_CHUNKS:.0f} kernel "
            f"launches and {busy / SF_LIVE_CHUNKS:.3f} ms device busy per chunk, idle share "
            f"{max(0.0, 1 - busy / ms):.3f}, launches {c}")
    print(line, flush=True)
    lines.append(line)
    del sf
    torch.cuda.empty_cache()
    print(f"phase 16 full width, reduced depth, f32, card vs CPU (tol {FAMILY_CARD_TOL} rel L2): "
          f"{diarizer_reduced_depth_parity(device)}", flush=True)
    return paths, err, lines

# ------------------------------------------------------------------ phase 17
TTS_CARD_TOL = 1e-4  # full width, reduced depth, f32: card against CPU
# the trained `tts` fixture end to end, card against CPU with the same draws:
# tests/test_torch_kokoro.py's SAMPLES_REL (the harmonic source's phase
# follows the F0 track's last ulps; the peak normalisation makes a gain of it)
TTS_SAMPLES_TOL = 1e-1
LSEEND_SECONDS = 300.0
KOKORO_TOKENS = (64, 256, 510)
KOKORO_FRAMES_PER_TOKEN = (2.0, 3.0)  # what random weights are calibrated to


def itn_cases() -> list[tuple[str, str, str]]:
    """(language, spoken, written) of every ITN vector of tests/test_native.py,
    read from the test file's parametrize lists (the file itself imports
    JAX, so it is parsed, not imported)."""
    import ast

    tree = ast.parse((REPO / "tests" / "test_native.py").read_text())
    cases = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef) or node.name not in (
                "test_itn_english", "test_normalize", "test_vectors"):
            continue
        for deco in node.decorator_list:
            if isinstance(deco, ast.Call) and getattr(deco.func, "attr", "") == "parametrize":
                names = [n.strip() for n in ast.literal_eval(deco.args[0]).split(",")]
                for row in ast.literal_eval(deco.args[1]):
                    bound = dict(zip(names, row))
                    cases.append((bound.get("lang", "en"), bound.get("spoken") or bound["src"],
                                  bound.get("written") or bound["want"]))
    return cases


def lseend_fixture_runs(device) -> dict:
    """The trained `lseend` fixture on `device`: `eval_lseend_fixture`'s DER,
    `process` segments, and a streaming session (ragged 1 s pushes, then
    `finish_stream`)."""
    from fluidaudio_tpu_torch.diarizer.lseend import LSEENDDiarizer
    from fluidaudio_tpu_torch.models.lseend import LSEEND_TEST
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    def segs(result):
        return [(s.speaker_id, round(s.start_time, 6), round(s.end_time, 6))
                for s in result.segments]

    diar = LSEENDDiarizer(LSEEND_TEST, step_ms=500, checkpoint_dir=TRAINED / "lseend",
                          device=device)
    mix = tc.diarizer_mixture(np.random.RandomState(8642), 60.0, overlap_prob=0.0)[0]
    stream_mix = tc.diarizer_mixture(np.random.RandomState(123), 30.0, overlap_prob=0.0)[0]
    diar.reset_session()
    stream = [segs(diar.process_stream(stream_mix[o : o + 16_000]))
              for o in range(0, stream_mix.size, 16_000)]
    stream.append(segs(diar.finish_stream()))
    return {"der": fx.eval_lseend_fixture(device=device), "process": segs(diar.process(mix)),
            "stream": stream}


def tts_fixture_runs(device, draws, spectra=None) -> dict:
    """The trained `tts` fixture on `device` with the given source draws
    (made on the CPU): per text its phonemes, durations, frame count, F0 and
    N tracks, the audio program's output and the samples. The harmonic
    source's STFTs are recorded into `spectra["out"]`, or, with
    `spectra["in"]`, replaced by those (the generator then reads the same
    source spectra on both devices: the source's phase integrates the F0
    track's last-ulp differences, which the STFT phases of its weak bins
    amplify)."""
    from fluidaudio_tpu_torch.models import kokoro as kk
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    mgr = fx.load_tts_manager(device=device)
    rand_ini, noise = (d.to(device) for d in draws)
    forward, stft = kk.KokoroAudioProgram.forward, kk.stft_20
    given = iter(spectra.get("in", ()))

    def source_stft(x, *a):
        if "in" in spectra:
            return tuple(t.to(x.device) for t in next(given))
        mag, ph = stft(x, *a)
        spectra.setdefault("out", []).append((mag.cpu(), ph.cpu()))
        return mag, ph

    out = {}
    try:
        kk.KokoroAudioProgram.forward = lambda self, *a, generator=None, **k: forward(
            self, *a, rand_ini=rand_ini, noise=noise, **k)
        kk.stft_20 = source_stft
        for ids in ([3, 7, 12], [15, 0], [5, 9, 2, 14, 1, 8]):
            text = tc.transcript_text(np.asarray(ids))
            phonemes = mgr.phonemes_for(text)
            style_s, timbre = mgr.style_for(phonemes, "af_test")
            dur, d, t_en = mgr.text_durations(mgr.encode_phonemes(phonemes), style_s)
            frame_idx, frames = kk.expand_durations(dur, mgr.cfg.max_frames)
            program, f0, n_ = mgr.audio_program(
                d, t_en, torch.as_tensor(frame_idx[None, :160].astype(np.int64)).to(device),
                torch.tensor([frames], dtype=torch.int32, device=device), style_s, timbre,
                with_prosody=True)
            out[text] = (phonemes, dur, frames, f0.cpu().numpy(), n_.cpu().numpy(),
                         program.cpu().numpy(), mgr.synthesize(text).samples)
    finally:
        kk.KokoroAudioProgram.forward, kk.stft_20 = forward, stft
    return out


def phase_fixtures_17(attn, i8, device) -> tuple[dict, str]:
    """The trained `lseend` and `tts` fixtures on the card against the port on
    the CPU, the tonal check and two equal synthesize calls on the card."""
    from fluidaudio_tpu_torch.models.kokoro import HARMONICS
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    paths, parts = {}, []
    card, c = counted(attn, i8, lambda: lseend_fixture_runs(device))
    cpu = lseend_fixture_runs("cpu")
    check(card == cpu, "lseend fixture on the card: DER, segments or stream differ from the CPU")
    check(card["der"] <= fx.LSEEND_DER_GATE, f"lseend fixture DER {card['der']} over the gate")
    paths["lseend fixture (phase 17)"] = c
    parts.append(f"lseend: DER {card['der']:.4f}, {len(card['process'])} segments, stream "
                 f"{sum(map(len, card['stream']))} segments over {len(card['stream'])} pushes "
                 f"(= CPU)")

    gen = torch.Generator().manual_seed(17)
    draws = (torch.rand((1, HARMONICS), generator=gen),
             torch.randn((1, 2 * 160 * 300, HARMONICS), generator=gen))
    spectra = {}
    cpu_tts = tts_fixture_runs("cpu", draws, spectra)
    card_tts, c = counted(attn, i8, lambda: tts_fixture_runs(device, draws,
                                                              {"in": spectra["out"]}))
    errs = {k: 0.0 for k in ("F0, N", "program", "samples")}
    for text, (ph, dur, frames, f0, n_, program, samples) in card_tts.items():
        c_ph, c_dur, c_frames, c_f0, c_n, c_program, c_samples = cpu_tts[text]
        check(ph == c_ph and frames == c_frames and samples.shape == c_samples.shape,
              f"tts fixture {text!r}: phonemes or frame count differ from the CPU")
        rel = lambda x, y: rel_l2(torch.as_tensor(x), torch.as_tensor(y))  # noqa: E731
        check(rel(dur, c_dur) <= FAMILY_CARD_TOL, f"tts fixture {text!r}: durations differ")
        for key, e in (("F0, N", max(rel(f0, c_f0), rel(n_, c_n))),
                       ("program", rel(program, c_program)),
                       ("samples", rel(samples, c_samples))):
            errs[key] = max(errs[key], e)
    check(all(e <= FAMILY_CARD_TOL for e in errs.values()), f"tts fixture card vs CPU: {errs}")
    # end to end (the card's own source STFTs): the test's tolerance on the
    # samples; at one gain (the peak normalisation's) for information
    free, c3 = counted(attn, i8, lambda: tts_fixture_runs(device, draws, {}))
    end = {"samples": 0.0, "at one gain": 0.0}
    for text, run in free.items():
        got, want = torch.as_tensor(run[-1], dtype=torch.float64), torch.as_tensor(
            cpu_tts[text][-1], dtype=torch.float64)
        gain = float(got @ want / (got @ got))
        end = {"samples": max(end["samples"], rel_l2(got, want)),
               "at one gain": max(end["at one gain"], rel_l2(gain * got, want))}
    check(end["samples"] <= TTS_SAMPLES_TOL, f"tts fixture end to end card vs CPU: {end}")
    mgr = fx.load_tts_manager(device=device)

    def tonal():
        peaks = []
        for w in (0, 7, 15):
            x = mgr.synthesize(tc.word_text(w)).samples
            body = x[int(0.05 * 24000): int(0.28 * 24000)]
            spec = np.abs(np.fft.rfft(body * np.hanning(body.size)))
            peaks.append((np.argmax(spec) * 24000 / body.size, tc.word_freq(w)))
        return peaks

    peaks, c2 = counted(attn, i8, tonal)
    check(all(abs(f - want) < 40.0 for f, want in peaks), f"tts fixture tones {peaks}")
    text = tc.transcript_text(np.array([4, 10, 6]))
    check(np.array_equal(mgr.synthesize(text).samples, mgr.synthesize(text).samples),
          "tts fixture: two synthesize calls on one text differ on the card")
    paths["tts fixture (phase 17)"] = {k: c[k] + c2[k] + c3[k] for k in c}
    parts.append(f"tts (the generator on the CPU's source STFTs): phonemes and frame counts "
                 f"equal; max rel L2 (tol {FAMILY_CARD_TOL}) "
                 + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                 + f"; end to end samples {end['samples']:.2e} (tol {TTS_SAMPLES_TOL}), at one "
                 f"gain {end['at one gain']:.2e}"
                 + f"; tones {[round(f, 1) for f, _ in peaks]} Hz (want "
                 f"{[round(w, 1) for _, w in peaks]}); two calls array_equal")
    return paths, " | ".join(parts)


def calibrate_duration_bias(mgr, phonemes: str) -> float:
    """Bisect the bias of `duration_proj` (all 50 outputs alike) until the
    text program's durations average 2-3 frames per token on `phonemes`, as
    speech's do; random weights give ~25. Sets it in place -> frames per
    token reached."""
    bias = mgr.text_program.duration_proj.bias
    ids = mgr.encode_phonemes(phonemes)
    style_s, _ = mgr.style_for(phonemes, mgr.default_voice)
    lo, hi, fpt = -20.0, 10.0, 0.0
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        with torch.no_grad():
            bias.fill_(mid)
        dur, _, _ = mgr.text_durations(ids, style_s)
        fpt = float(np.maximum(np.rint(dur), 1).mean())
        if KOKORO_FRAMES_PER_TOKEN[0] <= fpt <= KOKORO_FRAMES_PER_TOKEN[1]:
            break
        lo, hi = (lo, mid) if fpt > KOKORO_FRAMES_PER_TOKEN[1] else (mid, hi)
    return fpt


def phoneme_text(mgr, rs, n_tokens: int) -> str:
    """Words of the seed lexicon's IPA, space-joined, cut to `n_tokens`
    vocabulary tokens."""
    from fluidaudio_tpu_torch.tts.g2p import _SEED_LEXICON

    words = list(_SEED_LEXICON.values())
    out = ""
    while len(mgr.encode_phonemes(out)) < n_tokens:
        out += words[rs.randint(len(words))] + " "
    return out[:n_tokens].strip()


def time_synthesis(smi: str, label: str, fn, runs: int = 2) -> str:
    """`time_request` with the audio's length, then the KokoroStageTimings
    of the last call."""
    result = fn()
    line = time_request(smi, label, fn, result.duration, runs=runs)
    t = result.timings
    print(f"timing [{smi}] {label}: KokoroStageTimings g2p {t.g2p_seconds * 1e3:.3f} ms, text "
          f"{t.text_seconds * 1e3:.3f} ms, audio {t.audio_seconds * 1e3:.3f} ms, post "
          f"{t.post_seconds * 1e3:.3f} ms; {result.duration:.3f} s of audio", flush=True)
    return line


def kokoro_reduced_depth_parity(device) -> str:
    """Full width at reduced depth (`albert_layers` 2), f32, seeded random
    weights drawn on the card and copied to the CPU, the same source draws:
    durations, d, t_en and the audio program's output, card against CPU."""
    from dataclasses import replace

    from fluidaudio_tpu_torch.models import kokoro as kk
    from fluidaudio_tpu_torch.tts.kokoro_manager import KokoroManager

    # a 100-frame grid keeps the CPU's side short; every width stays full
    cfg = replace(kk.KokoroConfig(), albert_layers=2, frame_buckets=(100,))
    empty = REPO / "no-checkpoint"
    card = KokoroManager(config=cfg, checkpoint_dir=empty, device=device)
    calibrate_duration_bias(card, phoneme_text(card, np.random.RandomState(1), 40))
    cpu = KokoroManager(config=cfg, checkpoint_dir=empty, device="cpu")
    for prog in ("text_program", "audio_program"):
        getattr(cpu, prog).load_state_dict(
            {k: v.cpu() for k, v in getattr(card, prog).state_dict().items()})
    phonemes = phoneme_text(card, np.random.RandomState(2), 30)
    ids = card.encode_phonemes(phonemes)
    gen = torch.Generator().manual_seed(3)
    results = {}
    for key, mgr in (("card", card), ("cpu", cpu)):
        style_s, timbre = mgr.style_for(phonemes, mgr.default_voice)
        dur, d, t_en = mgr.text_durations(ids, style_s)
        frame_idx, frames = kk.expand_durations(dur, cfg.max_frames)
        bucket = mgr._bucket(frames, mgr.frame_buckets())
        if "draws" not in results:
            results["draws"] = (torch.rand((1, kk.HARMONICS), generator=gen),
                                torch.randn((1, 2 * bucket * 300, kk.HARMONICS), generator=gen))
        rand_ini, noise = (x.to(mgr.device) for x in results["draws"])
        audio = mgr.audio_program(
            d, t_en, torch.as_tensor(frame_idx[None, :bucket].astype(np.int64)).to(mgr.device),
            torch.tensor([frames], dtype=torch.int32, device=mgr.device), style_s, timbre,
            rand_ini=rand_ini, noise=noise)
        results[key] = (dur, d.cpu().numpy(), t_en.cpu().numpy(), frames, audio.cpu().numpy())
    a, b = results["card"], results["cpu"]
    errs = {k: rel_l2(torch.as_tensor(a[i]), torch.as_tensor(b[i]))
            for i, k in ((0, "durations"), (1, "d"), (2, "t_en"), (4, "audio"))}
    check(a[3] == b[3] and all(e <= TTS_CARD_TOL for e in errs.values()),
          f"kokoro reduced depth card vs CPU: frames {a[3]}/{b[3]}, rel L2 {errs}")
    return (f"Kokoro full width, ALBERT 2 layers, {len(ids)} tokens, {a[3]} frames "
            f"(grid {cfg.frame_buckets[0]}): "
            + ", ".join(f"{k} rel L2 {v:.2e}" for k, v in errs.items()))


def phase_tts_lseend_itn(attn, i8, device, smi: str) -> tuple[dict, list[str]]:
    """Phase 17: the trained `lseend` and `tts` fixtures on the card against
    the CPU; the ITN vectors; LS-EEND (LSEEND_BASE) and Kokoro-82M
    (KokoroConfig()) at full width with seeded random weights drawn on the
    card, each path counted (no kernel of the port is on them) and timed;
    Kokoro at full width, reduced depth, card against CPU. -> (launches per
    path, timing lines)."""
    from fluidaudio_tpu_torch.diarizer.lseend import LSEENDDiarizer
    from fluidaudio_tpu_torch.itn import TextNormalizer
    from fluidaudio_tpu_torch.models.kokoro import MAX_TOKENS
    from fluidaudio_tpu_torch.train import tiny_corpus as tc
    from fluidaudio_tpu_torch.tts.kokoro_manager import KokoroManager
    from fluidaudio_tpu_torch.tts.phoneme_chunker import chunk_phonemes

    t0, spent = time.perf_counter(), {}

    def lap(what):
        nonlocal t0
        spent[what] = time.perf_counter() - t0
        t0 = time.perf_counter()

    paths, summary = phase_fixtures_17(attn, i8, device)
    print(f"phase 17 trained fixtures on the card vs the CPU port: {summary} | launches "
          f"{paths}", flush=True)
    lap("fixtures")

    tn = TextNormalizer("en")
    cases = itn_cases()
    wrong = [(lang, src, want, got) for lang, src, want in cases
             if (got := tn.normalize(src, lang)) != want]
    check(len(cases) >= 60 and not wrong, f"ITN: {len(wrong)} of {len(cases)} wrong: {wrong[:3]}")
    print(f"phase 17 ITN ({tn.version}): {len(cases)} vectors of tests/test_native.py "
          f"(en, de, fr, es, pt, it, ru...) equal their expected strings", flush=True)
    lap("ITN")

    def path(label, fn):
        out, c = counted(attn, i8, fn)
        check(c["relpos_attention"] == 0 and c["int8_matmul_fused"] == 0
              and c["relpos_attention_plain calls"] == 0, f"{label}: launches {c}")
        paths[label] = c
        return out

    lines = []
    empty = REPO / "no-checkpoint"  # seeded random weights, drawn on the card
    audio = tc.diarizer_mixture(np.random.RandomState(300), LSEEND_SECONDS, overlap_prob=0.1)[0]
    for step_ms in (500, 100):
        diar = LSEENDDiarizer(step_ms=step_ms, checkpoint_dir=empty, device=device)
        label = f"LS-EEND (4 x 256, 23 mels, context 7) process, step {step_ms} ms, " \
                f"{LSEEND_SECONDS:.0f} s"
        result = path(label, lambda: diar.process(audio))
        check(all(0 <= s.start_time < s.end_time <= LSEEND_SECONDS for s in result.segments),
              f"{label}: a segment outside the recording")
        steps = int(LSEEND_SECONDS * 10) // diar.step_frames
        line = time_request(smi, f"{label}: {len(result.segments)} segments, {steps} steps",
                            lambda: diar.process(audio), LSEEND_SECONDS, runs=3,
                            per=(steps, "step"))
        lines.append(line)
    diar = LSEENDDiarizer(step_ms=500, checkpoint_dir=empty, device=device)

    def session():
        diar.reset_session()
        segs = [diar.process_stream(audio[o : o + 16_000]).segments
                for o in range(0, audio.size, 16_000)]
        return segs + [diar.finish_stream().segments]

    label = f"LS-EEND session, 500 ms steps, ragged 1 s pushes, {LSEEND_SECONDS:.0f} s"
    segs = path(label, session)
    check(len(segs) == int(LSEEND_SECONDS) + 1, f"{label}: {len(segs)} results")
    lines.append(time_request(smi, f"{label} (+ finish_stream)", session, LSEEND_SECONDS,
                              runs=2, per=(len(segs) - 1, "1 s push")))
    del diar
    torch.cuda.empty_cache()
    lap("LS-EEND")

    mgr = KokoroManager(checkpoint_dir=empty, device=device)  # KokoroConfig(): 82M
    n_params = sum(p.numel() for prog in (mgr.text_program, mgr.audio_program)
                   for p in prog.parameters())
    rs = np.random.RandomState(17)
    fpt = calibrate_duration_bias(mgr, phoneme_text(mgr, rs, 256))
    bias = float(mgr.text_program.duration_proj.bias[0].detach())
    print(f"phase 17 Kokoro-82M ({n_params / 1e6:.1f} M parameters) duration_proj bias "
          f"{bias:.3f}: {fpt:.2f} frames per token (random weights: ~25)", flush=True)
    for n in KOKORO_TOKENS:
        phonemes = phoneme_text(mgr, rs, n)
        n = len(mgr.encode_phonemes(phonemes))
        result = path(f"Kokoro-82M synthesize_from_phonemes, {n} tokens",
                      lambda: mgr.synthesize_from_phonemes(phonemes))
        check(np.isfinite(result.samples).all() and result.samples.size > 0,
              f"kokoro {n} tokens: samples")
        lines.append(time_synthesis(smi, f"Kokoro-82M synthesize_from_phonemes, {n} tokens "
                                         f"({result.samples.size // 600} frames)",
                                    lambda: mgr.synthesize_from_phonemes(phonemes)))
    # English long enough for the manager to cut it into two or more chunks
    text = " ".join(["the quick brown fox jumps over the lazy dog, and the speech test audio "
                     "is one two three four five."] * 6)
    chunks = len(chunk_phonemes(mgr.phonemes_for(text), MAX_TOKENS - 2))
    check(chunks >= 2, f"kokoro long text: {chunks} chunk(s)")
    result = path(f"Kokoro-82M synthesize, {len(text.split())} words ({chunks} chunks)",
                  lambda: mgr.synthesize(text))
    check(np.isfinite(result.samples).all() and np.abs(result.samples).max() <= 1.0,
          "kokoro long text: samples")
    lines.append(time_synthesis(smi, f"Kokoro-82M synthesize, {len(text.split())} words, "
                                     f"{chunks} chunks", lambda: mgr.synthesize(text)))
    check(np.array_equal(mgr.synthesize(text).samples, mgr.synthesize(text).samples),
          "kokoro full width: two synthesize calls on one text differ on the card")
    del mgr
    torch.cuda.empty_cache()
    lap("Kokoro")
    print(f"phase 17 full width, reduced depth, f32, card vs CPU (tol {TTS_CARD_TOL} rel L2): "
          f"{kokoro_reduced_depth_parity(device)}", flush=True)
    lap("parity")
    print("phase 17 seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()), flush=True)
    return paths, lines


# --------------------------------------------------------------- phase 18
G2P_WORDS = ["chat", "eau", "bonjour", "données", "schön", "straße", "hello", "world",
             "x", "anticonstitutionnellement"]
HANZI_TEXT = ("今天天气很好，我们一起去公园散步吧。银行的行长说，这个月的利率不会变。"
              "他们在2024年3月15日下午3点半见面，花了1250元。重庆的朋友长得很高。")
STYLETTS2_TOKENS = (64, 256)
SUPERTONIC_TEXT = ("The quick brown fox jumps over the lazy dog. Speech synthesis on a "
                   "graphics card should be fast.")


def pocket_fixture_runs(device, noise: torch.Tensor) -> dict:
    """The trained `pocket` fixture on `device`, every frame's noise taken
    from `noise` (made on the CPU): per text its frame count, done flags,
    EOS logits and samples; the `stream` blocks of one text; the cloned
    voice's prompt and its synthesis."""
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    mgr = fx.load_pocket_manager(device=device)
    lat = mgr.cfg.mimi.latent_dim
    mgr.frame_noise = lambda seed, n: noise[seed, :n].to(device)
    blocks = iter(noise[1:].reshape(-1, mgr.STREAM_BLOCK_FRAMES, lat))
    mgr.block_noise = lambda gen: next(blocks).to(device)
    out = {}
    for ids in ([3, 7, 12], [15, 0], [5, 9, 2, 14, 1, 8]):
        text = tc.transcript_text(np.asarray(ids))
        kv, pos, cond = mgr.prefill(mgr._tokenize(text), mgr.voices["default"])
        audio, done, eos = mgr.generate(kv, pos, cond, noise[0, : mgr.cfg.max_frames].to(device))
        result = mgr.synthesize(text)
        out[text] = (result.frames, done, eos, result.samples)
    out["stream"] = np.concatenate(list(mgr.stream(tc.transcript_text(np.asarray([1, 8])))))
    mgr.clone_voice(fx.pocket_voice_reference(), "cloned")
    out["clone"] = (mgr.voices["cloned"],
                    mgr.synthesize(tc.transcript_text(np.asarray([1, 8])), voice="cloned").samples)
    return out


def styletts2_fixture_runs(device, sources: dict) -> dict:
    """The trained `styletts2` fixture on `device`: per text its style
    vectors, durations, F0 and N tracks, the acoustic program's output and
    the samples. The harmonic source's outputs are recorded into
    `sources["out"]`, or, with `sources["in"]`, replaced by those."""
    from fluidaudio_tpu_torch.models import styletts2 as st
    from fluidaudio_tpu_torch.models.kokoro import expand_durations
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.train import tiny_corpus as tc
    from fluidaudio_tpu_torch.tts.styletts2_manager import text_cleaner_encode

    mgr = fx.load_styletts2_manager(device=device)
    ref = fx.styletts2_ref_clip()
    forward = st.HifiSourceModule.forward
    given = iter(sources.get("in", ()))

    def source(self, f0_up, *a, **k):
        if "in" in sources:
            return next(given).to(f0_up.device)
        har = forward(self, f0_up, *a, **k)
        sources.setdefault("out", []).append(har.cpu())
        return har

    out = {}
    try:
        st.HifiSourceModule.forward = source
        for u, ids in enumerate(([3, 7, 12], [15, 0], [5, 9, 2, 14, 1, 8])):
            text = tc.transcript_text(np.asarray(ids))
            tok = text_cleaner_encode(mgr.phonemizer.phonemize(text))
            tokens = np.zeros((1, mgr.token_bucket(len(tok))), np.int64)
            tokens[0, : len(tok)] = tok
            lengths = torch.tensor([len(tok)], dtype=torch.int32, device=device)
            bert_dur, d_en, t_en = mgr.text_prog(torch.as_tensor(tokens).to(device), lengths)
            s_pred, ref_s = mgr.styles(bert_dur, lengths, ref, u)
            ref128, s128 = st.blend_style(s_pred, ref_s)
            s128_t = torch.as_tensor(s128).to(device)
            d, logits = mgr.predict_prog(d_en, s128_t, lengths)
            dur = st.round_durations(logits[0].cpu().numpy(), len(tok))
            frame_idx, total = expand_durations(dur.astype(np.float64), mgr.cfg.max_frames)
            audio, f0, n_ = mgr.acoustic_prog(
                d, t_en, torch.as_tensor(frame_idx[None, :256].astype(np.int64)).to(device),
                torch.tensor([total], dtype=torch.int32, device=device), s128_t,
                torch.as_tensor(ref128).to(device), with_prosody=True)
            out[text] = (np.concatenate([s_pred, ref_s], axis=1), logits.cpu().numpy(), total,
                         f0.cpu().numpy(), n_.cpu().numpy(), audio.cpu().numpy(),
                         mgr.synthesize(text, reference_audio=ref, noise_seed=u).samples)
    finally:
        st.HifiSourceModule.forward = forward
    return out


def phase_fixtures_18(attn, i8, device) -> tuple[dict, str]:
    """The trained `pocket` and `styletts2` fixtures on the card against the
    port on the CPU, with the same frame noise."""
    paths, parts = {}, []
    noise = torch.randn((12, 250, 8), generator=torch.Generator().manual_seed(18))
    cpu = pocket_fixture_runs("cpu", noise)
    card, c = counted(attn, i8, lambda: pocket_fixture_runs(device, noise))
    errs, margin = {"samples": 0.0, "EOS logits": 0.0}, float("inf")
    for text, run in card.items():
        if text in ("stream", "clone"):
            continue
        frames, done, eos, samples = run
        c_frames, c_done, c_eos, c_samples = cpu[text]
        check(frames == c_frames and np.array_equal(done, c_done),
              f"pocket fixture {text!r}: frames {frames}/{c_frames} or done flags differ")
        errs["samples"] = max(errs["samples"], rel_l2(torch.as_tensor(samples),
                                                      torch.as_tensor(c_samples)))
        errs["EOS logits"] = max(errs["EOS logits"], float(np.abs(eos - c_eos).max()))
        margin = min(margin, float(np.abs(c_eos - (-4.0)).min()))
    stream_err = rel_l2(torch.as_tensor(card["stream"]), torch.as_tensor(cpu["stream"]))
    clone_err = max(rel_l2(torch.as_tensor(a), torch.as_tensor(b))
                    for a, b in zip(card["clone"], cpu["clone"]))
    check(card["stream"].shape == cpu["stream"].shape and stream_err <= FAMILY_CARD_TOL
          and clone_err <= FAMILY_CARD_TOL and errs["samples"] <= FAMILY_CARD_TOL,
          f"pocket fixture card vs CPU: {errs}, stream {stream_err}, clone {clone_err}")
    paths["pocket fixture (phase 18)"] = c
    parts.append(f"pocket: frame counts {[r[0] for k, r in card.items() if k not in ('stream', 'clone')]}"
                 f" and done flags equal; max rel L2 (tol {FAMILY_CARD_TOL}) samples "
                 f"{errs['samples']:.2e}, stream {stream_err:.2e} ({card['stream'].size} samples)"
                 f", clone prompt and samples {clone_err:.2e}; EOS logits max abs "
                 f"{errs['EOS logits']:.2e}, nearest to the threshold by {margin:.3f}")

    sources = {}
    cpu_st = styletts2_fixture_runs("cpu", sources)
    card_st, c = counted(attn, i8, lambda: styletts2_fixture_runs(device, {"in": sources["out"]}))
    errs = {k: 0.0 for k in ("styles", "duration logits", "F0, N", "program")}
    for text, (styles, logits, total, f0, n_, program, samples) in card_st.items():
        c_styles, c_logits, c_total, c_f0, c_n, c_program, c_samples = cpu_st[text]
        check(total == c_total and samples.shape == c_samples.shape,
              f"styletts2 fixture {text!r}: frame count {total}/{c_total}")
        rel = lambda x, y: rel_l2(torch.as_tensor(x), torch.as_tensor(y))  # noqa: E731
        for key, e in (("styles", rel(styles, c_styles)), ("duration logits", rel(logits, c_logits)),
                       ("F0, N", max(rel(f0, c_f0), rel(n_, c_n))),
                       ("program", rel(program, c_program))):
            errs[key] = max(errs[key], e)
    check(all(e <= FAMILY_CARD_TOL for e in errs.values()), f"styletts2 card vs CPU: {errs}")
    free, c2 = counted(attn, i8, lambda: styletts2_fixture_runs(device, {}))
    end = max(rel_l2(torch.as_tensor(run[-1]), torch.as_tensor(cpu_st[t][-1]))
              for t, run in free.items())
    check(end <= TTS_SAMPLES_TOL, f"styletts2 fixture end to end card vs CPU: {end}")
    paths["styletts2 fixture (phase 18)"] = {k: c[k] + c2[k] for k in c}
    parts.append(f"styletts2 (the generator on the CPU's harmonic source): frame counts "
                 f"{[r[2] for r in card_st.values()]} equal; max rel L2 (tol {FAMILY_CARD_TOL}) "
                 + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                 + f"; end to end samples {end:.2e} (tol {TTS_SAMPLES_TOL})")
    return paths, " | ".join(parts)


def copy_to_cpu(module: torch.nn.Module, cpu_module: torch.nn.Module) -> torch.nn.Module:
    cpu_module.load_state_dict({k: v.cpu() for k, v in module.state_dict().items()})
    return cpu_module


def phase_g2p(attn, i8, device) -> tuple[dict, str]:
    """MultilingualG2P at G2P_BASE and ByT5 at BYT5_SMALL (seeded random
    weights drawn on the card, copied to the CPU) on a batch of words: token
    ids equal; MandarinG2pw at G2PW_BASE: logits within 1e-5 relative L2;
    MandarinG2P and Kokoro's mandarin variant over it on a Hanzi paragraph:
    bopomofo and phoneme ids equal."""
    from fluidaudio_tpu_torch.models.bert_g2pw import G2PW_BASE, BertG2pw
    from fluidaudio_tpu_torch.models.byt5_g2p import BYT5_SMALL, ByT5G2P
    from fluidaudio_tpu_torch.models.zoo import random_init_
    from fluidaudio_tpu_torch.tts.g2p import MultilingualG2P
    from fluidaudio_tpu_torch.tts.kokoro_manager import KokoroManager
    from fluidaudio_tpu_torch.tts.mandarin_g2p import MandarinG2P, MandarinG2pw

    paths, parts = {}, []
    empty = REPO / "no-checkpoint"

    def g2p_ids():
        mg = MultilingualG2P(checkpoint_dir=empty, device=device)
        byt5 = ByT5G2P(BYT5_SMALL, device=device).eval()
        random_init_(byt5, torch.Generator(device=device).manual_seed(5))
        seq2seq = mg.decode_ids(G2P_WORDS, "fra")
        mg.byt5 = byt5
        return mg, seq2seq, mg.decode_ids(G2P_WORDS, "fra")

    (mg, seq_card, byt5_card), c = counted(attn, i8, g2p_ids)
    paths["MultilingualG2P seq2seq + ByT5-small (phase 18)"] = c
    cpu = MultilingualG2P(checkpoint_dir=empty, device="cpu")
    copy_to_cpu(mg.model, cpu.model)
    seq_cpu = cpu.decode_ids(G2P_WORDS, "fra")
    cpu.byt5 = copy_to_cpu(mg.byt5, ByT5G2P(BYT5_SMALL, device="cpu").eval())
    byt5_cpu = cpu.decode_ids(G2P_WORDS, "fra")
    check(np.array_equal(seq_card, seq_cpu) and np.array_equal(byt5_card, byt5_cpu),
          "G2P decoders: the card's token ids differ from the CPU's")
    parts.append(f"G2P seq2seq (G2P_BASE) and ByT5-small (12 + 4 x 1472) on {len(G2P_WORDS)} "
                 f"words: token ids equal ({seq_card.shape} and {byt5_card.shape})")

    catalog = {"行": {"xing2": 1, "hang2": 2}, "长": {"chang2": 3, "zhang3": 4},
               "重": {"zhong4": 5, "chong2": 6}, "得": {"de5": 7, "dei3": 8},
               "了": {"le5": 9, "liao3": 10}, "不": {"bu4": 11, "bu2": 12}}
    vocab = {"[UNK]": 100, "[CLS]": 101, "[SEP]": 102}
    for i, ch in enumerate(sorted(set(HANZI_TEXT))):
        vocab.setdefault(ch, 103 + i)

    def g2pw_card():
        model = BertG2pw(G2PW_BASE, device=device).eval()
        random_init_(model, torch.Generator(device=device).manual_seed(6))
        return MandarinG2pw(model, vocab, catalog)

    def mandarin(g2pw, dev):
        kok = KokoroManager(variant="mandarin", checkpoint_dir=empty, device=dev)
        kok.mandarin_g2p = MandarinG2P(g2pw=g2pw)
        bopomofo = kok.phonemes_for(HANZI_TEXT)
        return bopomofo, kok.encode_phonemes(bopomofo), kok

    targets = [i for i, ch in enumerate(HANZI_TEXT) if ch in catalog]
    card_g2pw, c = counted(attn, i8, g2pw_card)
    (logits, (bopomofo, ids, kok)), c2 = counted(attn, i8, lambda: (
        card_g2pw.logits(HANZI_TEXT, targets), mandarin(card_g2pw, device)))
    cpu_g2pw = MandarinG2pw(copy_to_cpu(card_g2pw.model, BertG2pw(G2PW_BASE, device="cpu").eval()),
                            vocab, catalog)
    c_logits = cpu_g2pw.logits(HANZI_TEXT, targets)
    c_bopomofo, c_ids, _ = mandarin(cpu_g2pw, "cpu")
    err = rel_l2(torch.as_tensor(logits), torch.as_tensor(c_logits))
    check(err <= 1e-5 and bopomofo == c_bopomofo and ids == c_ids,
          f"mandarin G2P card vs CPU: logits {err}, bopomofo equal {bopomofo == c_bopomofo}")
    result, c3 = counted(attn, i8, lambda: kok.synthesize(HANZI_TEXT))
    check(np.isfinite(result.samples).all() and result.samples.size > 0, "mandarin Kokoro samples")
    paths["Kokoro mandarin + g2pW BERT-base (phase 18)"] = {k: c[k] + c2[k] + c3[k] for k in c}
    parts.append(f"g2pW BERT-base (12 x 768, 21128 vocab, 700 labels) on {len(targets)} "
                 f"polyphone targets: logits rel L2 {err:.2e} (tol 1e-5); MandarinG2P and "
                 f"Kokoro mandarin on {len(HANZI_TEXT)} Hanzi: {len(ids)} phoneme ids equal; "
                 f"synthesize {result.samples.size / 24000:.2f} s")
    return paths, " | ".join(parts)


def calibrate_styletts2_durations(mgr, n_tokens: int) -> tuple[str, float]:
    """IPA phonemes of `n_tokens` TextCleaner tokens, and the
    `duration_proj` bias (all outputs alike) bisected until their rounded
    durations average 2-3 frames per token, as speech's do -> (phonemes,
    frames per token)."""
    from fluidaudio_tpu_torch.models.styletts2 import round_durations
    from fluidaudio_tpu_torch.tts.g2p import _SEED_LEXICON
    from fluidaudio_tpu_torch.tts.styletts2_manager import text_cleaner_encode

    rs, words, phonemes = np.random.RandomState(n_tokens), list(_SEED_LEXICON.values()), ""
    while len(text_cleaner_encode(phonemes)) < n_tokens:
        phonemes += words[rs.randint(len(words))] + " "
    phonemes = phonemes[: n_tokens - 1].strip()
    ids = text_cleaner_encode(phonemes)
    dev = mgr.device
    tokens = torch.zeros((1, mgr.token_bucket(len(ids))), dtype=torch.int64, device=dev)
    tokens[0, : len(ids)] = torch.as_tensor(ids)
    lengths = torch.tensor([len(ids)], dtype=torch.int32, device=dev)
    bert_dur, d_en, _ = mgr.text_prog(tokens, lengths)
    s_pred, ref_s = mgr.styles(bert_dur, lengths, None, 0)
    s128 = torch.as_tensor(0.7 * s_pred[:, 128:] + 0.3 * ref_s[:, 128:]).to(dev)
    bias = mgr.predict_prog.duration_proj.bias
    lo, hi, fpt = -20.0, 10.0, 0.0
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        with torch.no_grad():
            bias.fill_(mid)
        fpt = float(round_durations(mgr.predict_prog(d_en, s128, lengths)[1][0].cpu().numpy(),
                                    len(ids)).mean())
        if KOKORO_FRAMES_PER_TOKEN[0] <= fpt <= KOKORO_FRAMES_PER_TOKEN[1]:
            break
        lo, hi = (lo, mid) if fpt > KOKORO_FRAMES_PER_TOKEN[1] else (mid, hi)
    return phonemes, fpt


def tts_reduced_depth_parity(device) -> str:
    """StyleTTS2, PocketTTS and Supertonic-3 at full width, reduced depth,
    f32, seeded random weights drawn on the card and copied to the CPU:
    each program's outputs card against CPU (StyleTTS2's audio against the
    CPU in float64)."""
    from dataclasses import replace

    from fluidaudio_tpu_torch.models import pocket_tts as pt
    from fluidaudio_tpu_torch.models import styletts2 as st
    from fluidaudio_tpu_torch.models import supertonic3 as s3
    from fluidaudio_tpu_torch.tts.pocket_manager import PocketTtsManager
    from fluidaudio_tpu_torch.tts.styletts2_manager import StyleTTS2Manager, ref_mel_padded
    from fluidaudio_tpu_torch.tts.supertonic_manager import Supertonic3Manager

    empty, errs, parts = REPO / "no-checkpoint", {}, []

    def pair(cls, cfg, names):
        card = cls(cfg, checkpoint_dir=empty, device=device)
        cpu = cls(cfg, checkpoint_dir=empty, device="cpu")
        for name in names:
            copy_to_cpu(getattr(card, name), getattr(cpu, name))
        return card, cpu

    rel = lambda a, b: rel_l2(torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b)))  # noqa: E731
    cfg = replace(st.STYLETTS2_BASE, albert_layers=2, diff_layers=1)
    card, cpu = pair(StyleTTS2Manager, cfg, ("text_prog", "style_prog", "predict_prog",
                                             "acoustic_prog"))
    ids = np.random.RandomState(4).randint(1, 178, size=40)
    mel, used = ref_mel_padded(None, cfg.n_mels)
    outs, source, forward = {}, {}, st.HifiSourceModule.forward

    def replay(self, f0_up, *a, **k):  # every run's generator reads the CPU's source
        if "cpu" not in source:
            source["cpu"] = forward(self, f0_up, *a, **k).cpu()
        return source["cpu"].to(device=f0_up.device, dtype=f0_up.dtype)

    def run(m, dtype):
        dev = m.device
        for prog in ("text_prog", "style_prog", "predict_prog", "acoustic_prog"):
            getattr(m, prog).to(dtype)
        tokens = torch.as_tensor(ids[None]).to(dev)
        lengths = torch.tensor([40], dtype=torch.int32, device=dev)
        bert, d_en, t_en = m.text_prog(tokens, lengths)
        noise_init, noises_aux = m.style_noise(0)
        as_dev = lambda x: torch.as_tensor(x).to(dev, dtype)  # noqa: E731
        s_pred, ref_s = m.style_prog(as_dev(mel), torch.tensor([used], device=dev), bert, lengths,
                                     as_dev(noise_init), as_dev(noises_aux))
        d, logits = m.predict_prog(d_en, ref_s[:, 128:], lengths)
        frame_idx = torch.as_tensor(np.minimum(np.arange(100) // 2, 39)[None]).to(dev)
        audio, f0, n_ = m.acoustic_prog(d, t_en, frame_idx, torch.tensor([100], device=dev),
                                        ref_s[:, 128:], ref_s[:, :128], with_prosody=True)
        return [x.double().cpu().numpy() for x in (bert, t_en, s_pred, ref_s, logits, f0, n_,
                                                   audio)]

    try:
        st.HifiSourceModule.forward = replay
        outs = {"cpu": run(cpu, torch.float32), "card": run(card, torch.float32),
                "cpu f64": run(cpu, torch.float64)}
    finally:
        st.HifiSourceModule.forward = forward
    # the audio's own f32 rounding error is ~1e-4 at this depth (the
    # generator's 4 stages of AdaIN resblocks), on either device: the card's
    # is held against the CPU's float64 run
    errs["StyleTTS2"] = max(rel(a, b) for a, b in zip(outs["card"][:-1], outs["cpu"][:-1]))
    errs["StyleTTS2 audio vs f64"] = rel(outs["card"][-1], outs["cpu f64"][-1])
    parts.append(f"StyleTTS2 (ALBERT 2, denoiser 1 layer; 40 tokens, 100 frames; the "
                 f"generators on the CPU's harmonic source) text, style, predict, F0/N "
                 f"{errs['StyleTTS2']:.2e}, audio against the CPU's f64 run "
                 f"{errs['StyleTTS2 audio vs f64']:.2e} (the CPU's f32 run: "
                 f"{rel(outs['cpu'][-1], outs['cpu f64'][-1]):.2e}; card vs CPU "
                 f"{rel(outs['card'][-1], outs['cpu'][-1]):.2e})")

    mimi = replace(pt.POCKET_BASE.mimi, trans_layers=2)
    cfg = replace(pt.POCKET_BASE, n_layers=2, flow_blocks=2, mimi=mimi, max_frames=8)
    card, cpu = pair(PocketTtsManager, cfg, ("flowlm", "flow", "mimi", "mimi_enc"))
    noise = torch.randn((8, cfg.mimi.latent_dim), generator=torch.Generator().manual_seed(8))
    outs = {}
    for key, m in (("card", card), ("cpu", cpu)):
        tokens = m._tokenize("hello world, this is a test")
        kv, pos, cond = m.prefill(tokens, m.voices["default"])
        audio, done, eos = m.generate(kv, pos, cond, noise.to(m.device))
        lat = m.mimi_enc(torch.as_tensor(np.sin(np.arange(48_000) / 9.0, dtype=np.float32))
                         .to(m.device)[None]).cpu()
        outs[key] = (cond.cpu(), audio, eos, lat)
    errs["PocketTTS"] = max(rel(a, b) for a, b in zip(*outs.values()))
    parts.append(f"PocketTTS (flow-LM 2 layers, Mimi 2; prefill, 8 frames, encoder on 2 s) "
                 f"{errs['PocketTTS']:.2e}")

    cfg = replace(s3.SUPERTONIC3_BASE, n_text_layers=1, n_est_layers=1, max_latent=32)
    card, cpu = pair(Supertonic3Manager, cfg, ("text_enc", "dur_pred", "estimator", "vocoder"))
    for m in (card, cpu):  # flax's zero inits make the estimator the identity
        with torch.no_grad():
            for name, p in m.estimator.named_parameters():
                if name.endswith("mod.weight") or name == "out_proj.weight":
                    p.copy_(torch.sin(torch.arange(p.numel(), dtype=torch.float32))
                            .reshape(p.shape).to(p.device) * 0.02)
    outs = {key: m.synthesize("Hello world, this is a test.").samples
            for key, m in (("card", card), ("cpu", cpu))}
    errs["Supertonic-3"] = rel(outs["card"], outs["cpu"])
    parts.append(f"Supertonic-3 (1 text + 1 estimator layer, 8 steps, latent bucket 32) "
                 f"{errs['Supertonic-3']:.2e}")
    check(all(e <= TTS_CARD_TOL for e in errs.values()), f"TTS reduced depth card vs CPU: {errs}")
    return "; ".join(parts)


def phase_tts_rest(attn, i8, device, smi: str) -> tuple[dict, list[str]]:
    """Phase 18: the trained `pocket` and `styletts2` fixtures on the card
    against the CPU; the G2P decoders, g2pW and Kokoro's mandarin variant
    against the CPU; StyleTTS2 (STYLETTS2_BASE), PocketTTS (POCKET_BASE) and
    Supertonic-3 (SUPERTONIC3_BASE) at full width with seeded random weights
    drawn on the card, each path counted (no kernel of the port is on them)
    and timed; then the three at full width, reduced depth, card against
    CPU. -> (launches per path, timing lines)."""
    from fluidaudio_tpu_torch.tts.pocket_manager import PocketTtsManager
    from fluidaudio_tpu_torch.tts.styletts2_manager import StyleTTS2Manager
    from fluidaudio_tpu_torch.tts.supertonic_manager import Supertonic3Manager

    t0, spent = time.perf_counter(), {}

    def lap(what):
        nonlocal t0
        spent[what] = time.perf_counter() - t0
        t0 = time.perf_counter()

    paths, summary = phase_fixtures_18(attn, i8, device)
    print(f"phase 18 trained fixtures on the card vs the CPU port: {summary} | launches "
          f"{paths}", flush=True)
    lap("fixtures")
    g2p_paths, summary = phase_g2p(attn, i8, device)
    paths.update(g2p_paths)
    print(f"phase 18 G2P on the card vs the CPU port: {summary}", flush=True)
    lap("G2P")

    def path(label, fn):
        out, c = counted(attn, i8, fn)
        check(c["relpos_attention"] == 0 and c["int8_matmul_fused"] == 0
              and c["relpos_attention_plain calls"] == 0, f"{label}: launches {c}")
        paths[label] = c
        return out

    lines = []
    empty = REPO / "no-checkpoint"  # seeded random weights, drawn on the card
    mgr = StyleTTS2Manager(checkpoint_dir=empty, device=device)  # STYLETTS2_BASE
    ref = speechlike(np.random.RandomState(18), 3.0)
    for n in STYLETTS2_TOKENS:
        phonemes, fpt = calibrate_styletts2_durations(mgr, n)
        label = f"StyleTTS2 (LibriTTS) synthesize_phonemes, {n} tokens"
        result = path(label, lambda: mgr._synthesize_phonemes(phonemes, ref))
        check(np.isfinite(result.samples).all() and result.samples.size > 0, f"{label}: samples")
        lines.append(time_request(smi, f"{label} ({fpt:.2f} frames per token, "
                                       f"{result.duration:.2f} s of audio)",
                                  lambda: mgr._synthesize_phonemes(phonemes, ref),
                                  result.duration, runs=3))
    del mgr
    torch.cuda.empty_cache()
    lap("StyleTTS2")

    mgr = PocketTtsManager(checkpoint_dir=empty, device=device)  # POCKET_BASE
    with torch.no_grad():  # no EOS: all 250 frames are speech
        mgr.flowlm.eos_head.bias.fill_(-1e4)
    text = "The quick brown fox jumps over the lazy dog."  # one chunk (<= 50 tokens)
    label = f"PocketTTS (6 x 1024, Mimi 8 x 512) synthesize, {mgr.cfg.max_frames} frames"
    result = path(label, lambda: mgr.synthesize(text))
    check(result.frames == mgr.cfg.max_frames and np.isfinite(result.samples).all(),
          f"{label}: {result.frames} frames")
    lines.append(time_request(smi, label, lambda: mgr.synthesize(text), result.duration, runs=3,
                              per=(result.frames, "frame")))
    label = (f"PocketTTS stream, blocks of {mgr.STREAM_BLOCK_FRAMES} frames, "
             f"{mgr.cfg.max_frames} frames")
    blocks = path(label, lambda: list(mgr.stream(text)))
    check(len(blocks) == mgr.cfg.max_frames, f"{label}: {len(blocks)} frames")
    n_blocks = -(-mgr.cfg.max_frames // mgr.STREAM_BLOCK_FRAMES)
    lines.append(time_request(smi, label, lambda: list(mgr.stream(text)), result.duration,
                              runs=2, per=(n_blocks, "block")))
    voice = speechlike(np.random.RandomState(19), 5.0)
    label = "PocketTTS clone_voice (Mimi encoder, 10 s window)"
    path(label, lambda: mgr.clone_voice(voice, "cloned"))
    lines.append(time_request(smi, label, lambda: mgr.clone_voice(voice, "cloned"), 10.0,
                              runs=3))
    del mgr
    torch.cuda.empty_cache()
    lap("PocketTTS")

    mgr = Supertonic3Manager(checkpoint_dir=empty, device=device)  # SUPERTONIC3_BASE
    label = f"Supertonic-3 synthesize, {mgr.total_steps} steps, {len(SUPERTONIC_TEXT)} chars"
    result = path(label, lambda: mgr.synthesize(SUPERTONIC_TEXT))
    check(np.isfinite(result.samples).all() and result.samples.size > 0, f"{label}: samples")
    lines.append(time_request(smi, f"{label} ({result.duration:.2f} s of audio)",
                              lambda: mgr.synthesize(SUPERTONIC_TEXT), result.duration, runs=3))
    del mgr
    torch.cuda.empty_cache()
    lap("Supertonic-3")
    print(f"phase 18 full width, reduced depth, f32, card vs CPU (tol {TTS_CARD_TOL} rel L2): "
          f"{tts_reduced_depth_parity(device)}", flush=True)
    lap("parity")
    print("phase 18 seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()), flush=True)
    return paths, lines


# ------------------------------------------------------------ phase 19: the CLI

GUARDRAIL_TRAINED = ("asr", "vad", "sortformer", "sensevoice", "paraformer", "cohere", "eou",
                     "lseend", "nemotron", "ctc", "tts", "pocket", "styletts2", "offline",
                     "online")
GUARDRAIL_FAILING = ("tts", "pocket", "styletts2")  # the reference fails these at every commit
# the gate names each failing family's failures start with (cli/benchmarks.py)
GUARDRAIL_GATE_NAMES = {"tts": "trained TTS", "pocket": "trained PocketTTS",
                        "styletts2": "trained StyleTTS2"}
# the guardrail's roundtrip WERs of the two vocoders with a harmonic source
# (Kokoro, StyleTTS2): their audio follows the F0 track's last ulps (held
# stage by stage and end to end against the CPU in phases 17-18), so the
# trained ASR may read a word otherwise on the card than on the CPU. The
# roundtrip is split: the card's ASR, fed the CPU's synthesized audio, must
# give the CPU's transcripts and WER exactly; the card's own end to end
# roundtrip is held to the CPU's gate outcome. Every other number: the CPU's.
HARMONIC_ROUNDTRIPS = {"trained_tts_roundtrip_wer_pct": ("KokoroManager", "eval_tts_fixture"),
                       "trained_styletts2_roundtrip_wer_pct": ("StyleTTS2Manager",
                                                               "eval_styletts2_fixture")}
CLI_SPEECH_SECONDS = 30.0
CLI_STREAM_CHUNKS = 16
CLI_DIAR_SECONDS = 60.0


def run_cli(argv: list[str]) -> tuple[int, list[str]]:
    """The port's CLI in-process, `main(argv)` with its stdout captured and
    then printed -> (its return code, its stdout lines)."""
    import io

    from fluidaudio_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    for line in buf.getvalue().splitlines():
        print(f"    | {line}", flush=True)
    return rc, buf.getvalue().splitlines()


def guardrail_json(lines: list[str]) -> dict:
    return next(json.loads(line) for line in lines if line.startswith("{"))


def failed_gates(lines: list[str]) -> list[str]:
    head = "guardrail QUALITY GATE FAILED: "
    return next((line[len(head):].split("; ") for line in lines if line.startswith(head)), [])


def gate_names(failed: list[str]) -> list[str]:
    """The failed gates with their numbers masked ("trained TTS roundtrip WER
    # > #")."""
    return [re.sub(r"(?<![\w.])\d+(\.\d+)?%?", "#", gate) for gate in failed]


def gate_families(failed: list[str]) -> list[str | None]:
    """The family each failed gate belongs to (None: not a failing family's)."""
    return [next((fam for fam, name in GUARDRAIL_GATE_NAMES.items()
                  if gate.startswith(name + " ")), None) for gate in failed]


def cli_path(attn, i8, smi: str, paths: dict, label: str, argv: list[str], want_rc: int = 0,
             profiled: bool = True) -> tuple[list[str], list[tuple[int, int]], str]:
    """One CLI command on the card: every kernel count set to 0 just before
    and read just after, each ConformerEncoder call's (layers, head width)
    recorded, the device profiled (launches, busy; the host wall then holds
    the profiler's cost of tracing each launch) unless `profiled` is False,
    its host wall and peak memory. The attention kernel must launch once per layer of every
    encoder call whose head width it takes and the plain version run once
    per layer of the others (no plain call where the kernel applies); no
    int8 launch. -> (stdout lines, encoder calls, timing line)."""
    from torch.profiler import ProfilerActivity, profile

    from fluidaudio_tpu_torch.models.conformer import ConformerEncoder

    calls, forward = [], ConformerEncoder.forward

    def recorded(self, *a, **k):
        calls.append((self.cfg.n_layers, self.cfg.head_dim))
        return forward(self, *a, **k)

    def run():
        ConformerEncoder.forward = recorded
        try:
            with (profile(activities=[ProfilerActivity.CUDA]) if profiled
                  else contextlib.nullcontext()) as prof:
                t0 = time.perf_counter()
                out = run_cli(argv)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        finally:
            ConformerEncoder.forward = forward
        return out, prof, wall

    torch.cuda.reset_peak_memory_stats()
    ((rc, lines), prof, wall), c = counted(attn, i8, run)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(rc == want_rc, f"{label}: rc {rc}, want {want_rc}")
    takes = [attn.kernel_takes_head_dim(dh) for _, dh in calls]
    kernel = sum(n for (n, _), k in zip(calls, takes) if k)
    plain = sum(n for (n, _), k in zip(calls, takes) if not k)
    check(c["relpos_attention"] == kernel and c["relpos_attention_plain calls"] == plain
          and c["int8_matmul_fused"] == 0,
          f"{label}: launches {c}, encoder calls (layers, Dh) {calls}")
    paths[label] = c
    if profiled:
        kernels, busy = device_activity(prof)
        device = (f"{kernels} kernel launches, {busy:.3f} ms device busy, idle share "
                  f"{max(0.0, 1 - busy / wall):.3f} (profiled)")
    else:
        device = "launches and busy not profiled"
    line = (f"timing [{smi}] CLI {label}: {wall:.1f} ms per command (host wall, model set-up "
            f"included), {device}, peak {peak:.2f} GiB; attention {c['relpos_attention']}"
            f" launches over {len(calls)} encoder calls (layers, Dh: "
            f"{sorted(set(calls))}), plain {c['relpos_attention_plain calls']}")
    print(line, flush=True)
    return lines, calls, line


@contextlib.contextmanager
def roundtrip_tts(wrap):
    """`tts/roundtrip.py::tts_asr_roundtrip` (which the trained fixtures'
    evaluations import at call time) with its TTS manager replaced by
    `wrap(manager)`."""
    import fluidaudio_tpu_torch.tts.roundtrip as roundtrip

    original = roundtrip.tts_asr_roundtrip
    roundtrip.tts_asr_roundtrip = lambda tts, asr, text, *a, **k: original(
        wrap(tts), asr, text, *a, **k)
    try:
        yield
    finally:
        roundtrip.tts_asr_roundtrip = original


class SynthRecorder:
    """Stands in for a TTS manager: synthesizes through it and keeps each
    result, by the manager's class name."""

    def __init__(self, tts, kept: dict):
        self.tts, self.kept = tts, kept.setdefault(type(tts).__name__, [])

    def synthesize(self, text, **kw):
        self.kept.append(self.tts.synthesize(text, **kw))
        return self.kept[-1]


class SynthReplay:
    """Stands in for a TTS manager: returns the next kept result of `kept`,
    an iterator shared by every stand-in of one evaluation."""

    def __init__(self, kept):
        self.kept = kept

    def synthesize(self, text, **kw):
        return next(self.kept)


def asr_batch_invariance(device, dtype: str) -> tuple[bool, int, int | None]:
    """The guardrail's `asr_batch_invariant` pin on v3 (seeded random weights)
    at `dtype`: the token streams at chunk batch 1 and 3 -> (equal, tokens,
    index of the first difference)."""
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.zoo import AsrModels

    audio = (np.random.RandomState(7).randn(700_000) * 0.1).astype(np.float32)
    models = AsrModels.load("v3", allow_random_init=True, device=device, dtype=dtype)
    streams = [[(t.token_id, round(t.start_time, 3)) for t in AsrManager(
        models, ASRConfig(parallel_chunk_batch=bs)).transcribe(audio).token_timings]
        for bs in (1, 3)]
    first = next((i for i, (a, b) in enumerate(zip(*streams)) if a != b),
                 None if len(streams[0]) == len(streams[1]) else min(map(len, streams)))
    del models
    torch.cuda.empty_cache()
    return streams[0] == streams[1], len(streams[0]), first


def write_wav16(path: Path, samples: np.ndarray) -> Path:
    from fluidaudio_tpu_torch.utils.audio_io import write_wav

    write_wav(path, np.clip(samples, -1, 1), 16_000)
    return path


def phase_cli(attn, i8, device, smi: str) -> tuple[dict, list[str]]:
    """Phase 19: the port's CLI in-process on the card. `synthetic-guardrail`
    over the thirteen sections the reference passes (`pins` included): rc 0,
    each trained section's numbers equal to the port's CPU run, gate by
    gate; then `--families tts,pocket,styletts2`: rc 1, exactly those
    families' gates failing, as on the CPU, with the CPU's numbers (the
    harmonic-source roundtrips: the CPU's gate outcome end to end, and the
    CPU's WER from the card's ASR on the CPU's audio). `transcribe --version
    v3 --allow-random-init` on 30 s: the text of `AsrManager.transcribe`
    on the card, 24 attention launches per encoder call. `benchmark
    --workload all --batch 128` (four metric lines; 17 launches per
    Sortformer encoder call), `streaming-latency-benchmark --chunks 16 --iters 1`,
    `diarize --mode sortformer --rttm`, `tts-asr-verify --trained-fixture`
    and `normalize`. Every command counted and timed, and profiled but the
    streaming probe. -> (launches per path, timing lines)."""
    import tempfile

    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.zoo import AsrModels
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    t0, spent, paths, lines = time.perf_counter(), {}, {}, []

    def lap(what):
        nonlocal t0
        spent[what] = time.perf_counter() - t0
        t0 = time.perf_counter()

    cpu_synth = {}
    with roundtrip_tts(lambda tts: SynthRecorder(tts, cpu_synth)):
        rc, out = run_cli(["--device", "cpu", "synthetic-guardrail", "--families",
                           ",".join(GUARDRAIL_TRAINED)])
    cpu, cpu_failed = guardrail_json(out), failed_gates(out)
    families = gate_families(cpu_failed)
    check(rc == 1 and None not in families and set(families) == set(GUARDRAIL_FAILING),
          f"guardrail on the CPU: rc {rc}, failed gates {cpu_failed}")
    lap("guardrail on the CPU")

    passing = [f for f in (*GUARDRAIL_TRAINED, "pins") if f not in GUARDRAIL_FAILING]
    out, _, line = cli_path(attn, i8, smi, paths, "CLI synthetic-guardrail, 13 sections",
                            ["synthetic-guardrail", "--families", ",".join(passing)])
    card = guardrail_json(out)
    differ = {k: (v, cpu[k]) for k, v in card.items() if k.startswith("trained_") and v != cpu[k]}
    check(not differ and sum(k.startswith("trained_") for k in card) == 19,
          f"guardrail trained numbers card vs CPU: {differ}")
    check(card["backend"] == "cuda" and card["asr_tokens"] > 0, f"guardrail pins: {card}")
    lines.append(line)
    lap("guardrail, 13 sections")
    # the pin `asr_batch_invariant` (chunk batch 1 against 3, v3 random weights):
    # the same streams in f32, and in the CLI's bf16 what the pin reads
    f32 = asr_batch_invariance(device, "float32")
    check(f32[0], f"v3 f32 chunk batch 1 vs 3: token streams differ {f32}")
    print(f"phase 19 asr_batch_invariant pin (v3, random weights, 43.75 s): bf16 "
          f"{card['asr_batch_invariant']} ({card['asr_tokens']} tokens), f32 {f32[0]} "
          f"({f32[1]} tokens, first difference at {f32[2]})", flush=True)
    lap("batch invariance probe")
    out, _, line = cli_path(attn, i8, smi, paths, "CLI synthetic-guardrail tts,pocket,styletts2",
                            ["synthetic-guardrail", "--families", ",".join(GUARDRAIL_FAILING)],
                            want_rc=1)
    card_tts = guardrail_json(out)
    differ = {k: (v, cpu[k]) for k, v in card_tts.items() if k.startswith("trained_")
              and k not in HARMONIC_ROUNDTRIPS and v != cpu[k]}
    gate = fx.TTS_ROUNDTRIP_WER_GATE * 100  # the Kokoro and StyleTTS2 gates (both 2%)
    outcome = {k: (card_tts[k], cpu[k]) for k in HARMONIC_ROUNDTRIPS
               if (card_tts[k] > gate) != (cpu[k] > gate)}
    check(not differ and not outcome and gate_names(failed_gates(out)) == gate_names(cpu_failed),
          f"failing sections card vs CPU: numbers {differ}, gate outcomes {outcome}, gates "
          f"{failed_gates(out)} vs {cpu_failed}")
    lines.append(line)
    # the split roundtrip: the card's trained ASR on the CPU's synthesized audio
    replayed = {}
    for key, (manager, evaluate) in HARMONIC_ROUNDTRIPS.items():
        kept = cpu_synth.get(manager, [])
        with roundtrip_tts(lambda tts, _kept=iter(kept): SynthReplay(_kept)):
            run = getattr(fx, evaluate)(device=device)
        replayed[key] = round(run["roundtrip_wer_avg"] * 100, 2)
        check(len(kept) == len(run["utterances"]) > 0 and replayed[key] == cpu[key],
              f"{key}: the card's ASR on the CPU's {len(kept)} synthesized utterances reads "
              f"{replayed[key]}% ({run['utterances']}), the CPU {cpu[key]}%")
    print(f"phase 19 guardrail: 13 sections rc 0, {sum(k.startswith('trained_') for k in card)} "
          f"trained numbers equal to the CPU's; tts,pocket,styletts2 rc 1, the same "
          f"{len(cpu_failed)} failed gates as the CPU ({gate_names(cpu_failed)}), every number "
          f"the CPU's but the harmonic-source roundtrips, whose WER (card end to end; card ASR "
          f"on the CPU's audio; CPU) reads "
          + ", ".join(f"{k} {card_tts[k]}; {replayed[k]}; {cpu[k]}" for k in HARMONIC_ROUNDTRIPS),
          flush=True)
    lap("guardrail, failing sections")

    with tempfile.TemporaryDirectory() as tmp:
        wav = write_wav16(Path(tmp) / "speech.wav",
                          speechlike(np.random.RandomState(19), CLI_SPEECH_SECONDS))
        out, calls, line = cli_path(attn, i8, smi, paths, "CLI transcribe v3, 30 s",
                                    ["transcribe", str(wav), "--version", "v3",
                                     "--allow-random-init"])
        check(all(c == (24, 128) for c in calls) and calls, f"transcribe encoder calls {calls}")
        manager = AsrManager(AsrModels.load("v3", allow_random_init=True, device=device),
                             ASRConfig(parallel_chunk_batch=4))
        direct = manager.transcribe(wav)
        check(out[0] == f"{wav}: {direct.text}",
              f"transcribe: CLI {out[0]!r} vs AsrManager {direct.text!r}")
        lines.append(line)
        lines.append(time_request(smi, f"v3 AsrManager.transcribe of the same 30 s file "
                                       f"({len(direct.text.split())} words)",
                                  lambda: manager.transcribe(wav), CLI_SPEECH_SECONDS, runs=3))
        del manager
        torch.cuda.empty_cache()
        lap("transcribe")

        out, calls, line = cli_path(attn, i8, smi, paths, "CLI benchmark all, batch 128",
                                    ["benchmark", "--workload", "all", "--batch", "128"])
        metrics = [json.loads(x) for x in out if x.startswith("{")]
        check([m["metric"] for m in metrics] == ["asr_batch_rtfx", "vad_rtfx",
                                                 "eou_streaming_p50_chunk_latency",
                                                 "sortformer_offline_rtfx"]
              and all(m["value"] > 0 for m in metrics), f"benchmark lines {metrics}")
        check(set(calls) == {(24, 128), (17, 64)} and calls.count((24, 128)) == 4,
              f"benchmark encoder calls {calls}")
        lines.append(line + " | " + " ".join(json.dumps(m) for m in metrics))
        torch.cuda.empty_cache()
        lap("benchmark")

        # not profiled: the RNN-T loop at its token cap makes ~10^4
        # launches per chunk step, whose tracing would swamp the wall; the
        # command times itself
        label = f"CLI streaming-latency-benchmark, {CLI_STREAM_CHUNKS}"
        out, calls, line = cli_path(attn, i8, smi, paths, label,
                                    ["streaming-latency-benchmark", "--chunks",
                                     str(CLI_STREAM_CHUNKS), "--iters", "1"], profiled=False)
        probe = guardrail_json(out)
        check(probe["backend"] == "cuda" and not calls
              and all(probe[f"eou_{t}ms"]["device_per_chunk_ms"] > 0 for t in (160, 320, 1280)),
              f"streaming-latency-benchmark {probe}")
        lines.append(line + " | " + json.dumps(probe))
        lap("streaming latency")

        mix, _, _ = tc.diarizer_mixture(np.random.RandomState(19), CLI_DIAR_SECONDS)
        wav = write_wav16(Path(tmp) / "meeting.wav", mix)
        out, calls, line = cli_path(attn, i8, smi, paths, "CLI diarize sortformer, 60 s",
                                    ["diarize", str(wav), "--mode", "sortformer", "--rttm"])
        check(calls and all(c == (17, 64) for c in calls), f"diarize encoder calls {calls}")
        lines.append(line)
        out, _, line = cli_path(attn, i8, smi, paths, "CLI tts-asr-verify trained fixture",
                                ["tts-asr-verify", "w3 w7 w1", "--trained-fixture"])
        check(any(x.startswith("wer: ") for x in out), f"tts-asr-verify {out}")
        lines.append(line)
        out, _, _ = cli_path(attn, i8, smi, paths, "CLI normalize",
                             ["normalize", "twenty", "one", "dollars"])
        check(out == ["$21"], f"normalize {out}")
        lap("diarize, tts-asr-verify, normalize")
    print("phase 19 seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()), flush=True)
    return paths, lines


# ---------------------------------------------------------------- phase 20
# the checkpoint converters: a full-width Parakeet v3 in NeMo's key names
# goes through the port's `convert_nemo_file` and is served from its npz


CONVERT_SEED = 20
CONVERTED_REQUEST_S = (15.0, 15.0, 15.0)
ORACLE_TOL = 1e-4  # relative L2, f32 with TF32 off on both sides (PERF.md section 2)


class OracleSubsampling(torch.nn.Module):
    """NeMo's dw_striding ConvSubsampling (a copy of the oracle of
    tests/test_conformer_nemo_parity.py, which this script cannot import)."""

    def __init__(self, n_mels, channels, d_model):
        super().__init__()
        c = channels
        self.conv0 = torch.nn.Conv2d(1, c, 3, stride=2, padding=1)
        self.conv2 = torch.nn.Conv2d(c, c, 3, stride=2, padding=1, groups=c)
        self.conv3 = torch.nn.Conv2d(c, c, 1)
        self.conv5 = torch.nn.Conv2d(c, c, 3, stride=2, padding=1, groups=c)
        self.conv6 = torch.nn.Conv2d(c, c, 1)
        f8 = n_mels
        for _ in range(3):
            f8 = (f8 + 2 - 3) // 2 + 1
        self.out = torch.nn.Linear(c * f8, d_model)

    def forward(self, x):  # x [B, T, F]
        x = torch.relu(self.conv0(x.unsqueeze(1)))
        x = torch.relu(self.conv3(self.conv2(x)))
        x = torch.relu(self.conv6(self.conv5(x)))
        b, c, t, f = x.shape
        return self.out(x.transpose(1, 2).reshape(b, t, c * f))  # channel-major


def oracle_rel_sinusoid(T, d_model, device):
    """NeMo RelPositionalEncoding: positions T-1 .. -(T-1), sin/cos interleaved."""
    pos = torch.arange(T - 1, -T, -1, dtype=torch.float32, device=device).unsqueeze(1)
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * -(np.log(10000.0) / d_model))
    pe = torch.zeros(2 * T - 1, d_model, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class OracleRelPosMHSA(torch.nn.Module):
    def __init__(self, d_model, n_heads):
        super().__init__()
        self.h, self.dk = n_heads, d_model // n_heads
        self.linear_q = torch.nn.Linear(d_model, d_model)
        self.linear_k = torch.nn.Linear(d_model, d_model)
        self.linear_v = torch.nn.Linear(d_model, d_model)
        self.linear_out = torch.nn.Linear(d_model, d_model)
        self.linear_pos = torch.nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = torch.nn.Parameter(torch.randn(self.h, self.dk) * 0.1)
        self.pos_bias_v = torch.nn.Parameter(torch.randn(self.h, self.dk) * 0.1)

    def forward(self, x, pos_emb, mask):  # mask True where invalid
        B, T, D = x.shape
        q = self.linear_q(x).view(B, T, self.h, self.dk)
        k = self.linear_k(x).view(B, T, self.h, self.dk).transpose(1, 2)
        v = self.linear_v(x).view(B, T, self.h, self.dk).transpose(1, 2)
        p = self.linear_pos(pos_emb).view(-1, self.h, self.dk).permute(1, 0, 2)
        ac = torch.matmul((q + self.pos_bias_u).transpose(1, 2), k.transpose(-2, -1))
        bd = torch.matmul((q + self.pos_bias_v).transpose(1, 2), p.unsqueeze(0).transpose(-2, -1))
        b, h, qlen, pos_len = bd.shape  # NeMo rel_shift
        bd = torch.nn.functional.pad(bd, (1, 0)).view(b, h, -1, qlen)[:, :, 1:]
        bd = bd.reshape(b, h, qlen, pos_len)[:, :, :, :T]
        scores = ((ac + bd) / np.sqrt(self.dk)).masked_fill(mask[:, None], -10000.0)
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        return self.linear_out(out.transpose(1, 2).reshape(B, T, D))


class OracleConvModule(torch.nn.Module):
    def __init__(self, d_model, kernel):
        super().__init__()
        self.pointwise_conv1 = torch.nn.Conv1d(d_model, 2 * d_model, 1)
        self.depthwise_conv = torch.nn.Conv1d(d_model, d_model, kernel,
                                              padding=(kernel - 1) // 2, groups=d_model)
        self.batch_norm = torch.nn.BatchNorm1d(d_model)
        with torch.no_grad():  # eval-mode statistics that exercise the BN fold
            self.batch_norm.running_mean.normal_(0, 0.1)
            self.batch_norm.running_var.uniform_(0.5, 1.5)
            self.batch_norm.weight.uniform_(0.5, 1.5)
            self.batch_norm.bias.normal_(0, 0.1)
        self.pointwise_conv2 = torch.nn.Conv1d(d_model, d_model, 1)

    def forward(self, x, pad_mask):
        x = torch.nn.functional.glu(self.pointwise_conv1(x.transpose(1, 2)), dim=1)
        x = self.depthwise_conv(x.masked_fill(pad_mask.unsqueeze(1), 0.0))
        x = self.pointwise_conv2(torch.nn.functional.silu(self.batch_norm(x)))
        return x.transpose(1, 2)


class OracleFFN(torch.nn.Module):
    def __init__(self, d_model, d_ff):
        super().__init__()
        self.linear1 = torch.nn.Linear(d_model, d_ff)
        self.linear2 = torch.nn.Linear(d_ff, d_model)

    def forward(self, x):
        return self.linear2(torch.nn.functional.silu(self.linear1(x)))


class OracleConformerLayer(torch.nn.Module):
    def __init__(self, d_model, n_heads, d_ff, kernel):
        super().__init__()
        self.norm_feed_forward1 = torch.nn.LayerNorm(d_model)
        self.feed_forward1 = OracleFFN(d_model, d_ff)
        self.norm_self_att = torch.nn.LayerNorm(d_model)
        self.self_attn = OracleRelPosMHSA(d_model, n_heads)
        self.norm_conv = torch.nn.LayerNorm(d_model)
        self.conv = OracleConvModule(d_model, kernel)
        self.norm_feed_forward2 = torch.nn.LayerNorm(d_model)
        self.feed_forward2 = OracleFFN(d_model, d_ff)
        self.norm_out = torch.nn.LayerNorm(d_model)

    def forward(self, x, pos_emb, att_mask, pad_mask):
        x = x + 0.5 * self.feed_forward1(self.norm_feed_forward1(x))
        x = x + self.self_attn(self.norm_self_att(x), pos_emb, att_mask)
        x = x + self.conv(self.norm_conv(x), pad_mask)
        x = x + 0.5 * self.feed_forward2(self.norm_feed_forward2(x))
        return self.norm_out(x)


class OracleEncoder(torch.nn.Module):
    """NeMo's FastConformer encoder written from its public semantics."""

    def __init__(self, ccfg):
        super().__init__()
        d = ccfg.d_model
        self.pre_encode = OracleSubsampling(ccfg.n_mels, ccfg.subsampling_channels, d)
        self.layers = torch.nn.ModuleList(
            OracleConformerLayer(d, ccfg.n_heads, d * ccfg.ffn_expansion, ccfg.conv_kernel)
            for _ in range(ccfg.n_layers))
        self.xscale = float(np.sqrt(d)) if ccfg.xscale else None
        self.d_model = d

    def forward(self, mel, lengths):  # mel [B, F, T]
        x = self.pre_encode(mel.transpose(1, 2))
        if self.xscale:
            x = x * self.xscale
        T = x.shape[1]
        out_len = lengths
        for _ in range(3):
            out_len = torch.div(out_len + 2 - 3, 2, rounding_mode="floor") + 1
        valid = torch.arange(T, device=x.device)[None, :] < out_len[:, None]
        att_mask = ~(valid[:, :, None] & valid[:, None, :])
        pos_emb = oracle_rel_sinusoid(T, self.d_model, x.device)
        for layer in self.layers:
            x = layer(x, pos_emb, att_mask, ~valid)
        return x, out_len

    def nemo_state_dict(self) -> dict[str, torch.Tensor]:
        """Own parameters under NeMo's checkpoint keys, on the CPU."""
        names = {"pre_encode.conv0": "pre_encode.conv.0", "pre_encode.conv2": "pre_encode.conv.2",
                 "pre_encode.conv3": "pre_encode.conv.3", "pre_encode.conv5": "pre_encode.conv.5",
                 "pre_encode.conv6": "pre_encode.conv.6"}
        sd = {}
        for key, value in self.state_dict().items():
            if key.endswith("num_batches_tracked"):
                continue
            owner, leaf = key.rsplit(".", 1)
            sd[f"encoder.{names.get(owner, owner)}.{leaf}"] = value.detach().cpu()
        return sd


def nemo_checkpoint(ccfg, pcfg, seed: int, device) -> tuple[OracleEncoder, dict]:
    """A seeded NeMo FastConformer-TDT checkpoint: the oracle encoder (its
    torch init on `device`) and the state dict in NeMo's key names (CPU
    tensors), with the TDT prediction net and joint drawn beside it."""
    torch.manual_seed(seed)
    with torch.device(device):
        oracle = OracleEncoder(ccfg).eval()
    sd = oracle.nemo_state_dict()
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g) * 0.05
    P, J = pcfg.pred_hidden, pcfg.joint_hidden
    sd["decoder.prediction.embed.weight"] = rnd(pcfg.vocab_size + 1, P)
    for layer in range(pcfg.n_layers):
        for kind, cols in (("ih", P), ("hh", P)):
            sd[f"decoder.prediction.dec_rnn.lstm.weight_{kind}_l{layer}"] = rnd(4 * P, cols)
            sd[f"decoder.prediction.dec_rnn.lstm.bias_{kind}_l{layer}"] = rnd(4 * P)
    n_out = pcfg.num_token_logits + pcfg.n_durations
    for key, shape in (("joint.enc", (J, pcfg.enc_hidden)), ("joint.pred", (J, P)),
                       ("joint.joint_net.2", (n_out, J))):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = rnd(*shape), rnd(shape[0])
    return oracle, sd


def nemo_tar(path: Path, sd: dict, yaml_text: str) -> None:
    """A `.nemo` archive: `model_weights.ckpt` and `model_config.yaml`."""
    import io
    import tarfile

    buf = io.BytesIO()
    torch.save(sd, buf)
    with tarfile.open(path, "w") as tar:
        for name, data in (("./model_weights.ckpt", buf.getvalue()),
                           ("./model_config.yaml", yaml_text.encode())):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


def npz_key_count(path: Path) -> int:
    with np.load(path) as data:
        return len(data.files)


def valid_rel_l2(a: torch.Tensor, b: torch.Tensor, lengths: list[int]) -> float:
    """Relative L2 of a against b over each row's first lengths[i] frames."""
    a = torch.cat([a[i, :n] for i, n in enumerate(lengths)])
    b = torch.cat([b[i, :n] for i, n in enumerate(lengths)])
    return rel_l2(a.double(), b.double())


def phase_convert(attn, i8, device, smi: str) -> dict:
    """Checkpoint conversion on the port, then serving from its npz: a seeded
    full-width Parakeet v3 checkpoint in NeMo's key names (`torch.save`, raw
    ckpt) through `convert_nemo_file`; a test-tiny `.nemo` tar with a
    `model_config.yaml` (its overrides apply where PyYAML is installed, the
    preset stays where it is not, as in JAX); the converted v3 through
    `AsrModels.load(checkpoint_dir=..., allow_random_init=False)` in bf16 and
    int8 and `AsrManager` on 15 s requests (24 attention launches per encoder
    call, 265 int8 launches per int8 call); its f32 encoder against the NeMo
    oracle on the raw state dict; a test-width Supertonic-3 ONNX release
    converted in place by `Supertonic3Manager` and synthesized."""
    import importlib.util
    import tempfile
    from dataclasses import replace

    from torch.profiler import ProfilerActivity, profile

    from fluidaudio_tpu_torch.convert.parakeet import convert_nemo_file
    from fluidaudio_tpu_torch.convert.supertonic3 import STAGES, synthesize_supertonic3_fixture
    from fluidaudio_tpu_torch.models.conformer import ConformerEncoder
    from fluidaudio_tpu_torch.models.predictor import RnntJoint, RnntPredictor
    from fluidaudio_tpu_torch.models.supertonic3 import SUPERTONIC3_TEST
    from fluidaudio_tpu_torch.models.zoo import ASR_VERSIONS, AsrModels, disable_tf32
    from fluidaudio_tpu_torch.tts.supertonic_manager import Supertonic3Manager
    from fluidaudio_tpu_torch.utils.weights import from_jax_params, load_npz, load_state

    disable_tf32()
    paths = {}
    spec = ASR_VERSIONS["v3"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_convert_") as tmp:
        tmp = Path(tmp)
        # -- the full-width v3 checkpoint, converted
        t0 = time.perf_counter()
        oracle, sd = nemo_checkpoint(spec.conformer, spec.predictor, CONVERT_SEED, device)
        n_params = sum(v.numel() for v in sd.values())
        ckpt = tmp / "parakeet-tdt-0.6b-v3.ckpt"
        torch.save(sd, ckpt)
        del sd
        write_s = time.perf_counter() - t0
        ckpt_gb = ckpt.stat().st_size / 1e9
        t0 = time.perf_counter()
        convert_nemo_file(ckpt, tmp / "v3", spec.conformer, spec.predictor)
        convert_s = time.perf_counter() - t0
        parts = {name: tmp / "v3" / f"{name}.npz" for name in ("encoder", "predictor", "joint")}
        check(all(p.exists() for p in parts.values()), "convert_nemo_file wrote no npz")
        npz_gb = sum(p.stat().st_size for p in parts.values()) / 1e9
        ckpt.unlink()
        print(f"phase 20 convert [{smi}]: Parakeet v3 checkpoint ({spec.conformer.n_layers} x "
              f"{spec.conformer.d_model}, Dh {spec.conformer.head_dim}, {n_params / 1e9:.3f} B "
              f"params, NeMo keys, seed {CONVERT_SEED}) drawn and written with torch.save in "
              f"{write_s:.2f} s ({ckpt_gb:.3f} GB); convert_nemo_file {convert_s:.2f} s: "
              f"{npz_gb:.3f} GB of npz, {npz_gb / convert_s:.3f} GB/s written, "
              f"{ckpt_gb / convert_s:.3f} GB/s of checkpoint read", flush=True)

        # -- a test-tiny .nemo tar whose yaml adds a layer to the preset
        tiny = ASR_VERSIONS["test-tiny"]
        deeper = replace(tiny.conformer, n_layers=tiny.conformer.n_layers + 1, dtype="float32")
        tiny_oracle, tiny_sd = nemo_checkpoint(deeper, tiny.predictor, CONVERT_SEED + 1, "cpu")
        nemo_tar(tmp / "tiny.nemo", tiny_sd,
                 f"encoder:\n  n_layers: {deeper.n_layers}\n  d_model: {deeper.d_model}\n")
        convert_nemo_file(tmp / "tiny.nemo", tmp / "tiny", tiny.conformer, tiny.predictor)
        have_yaml = importlib.util.find_spec("yaml") is not None
        with np.load(tmp / "tiny" / "encoder.npz") as data:
            blocks = {k.split("/")[1] for k in data.files if k.split("/")[1].startswith("block")}
        n_layers = deeper.n_layers if have_yaml else tiny.conformer.n_layers
        check(len(blocks) == n_layers,
              f".nemo tar: {len(blocks)} blocks, want {n_layers} (PyYAML "
              f"{'present' if have_yaml else 'absent'})")
        enc_cfg = replace(deeper, n_layers=n_layers)
        tiny_enc = ConformerEncoder(enc_cfg, device=device).eval()
        for part, module in (("encoder", tiny_enc),
                             ("predictor", RnntPredictor(tiny.predictor, device=device)),
                             ("joint", RnntJoint(tiny.predictor, device=device))):
            load_state(module, load_npz(tmp / "tiny" / f"{part}.npz"))  # raises on a key left over
        tiny_oracle.layers = tiny_oracle.layers[:n_layers]
        rs = np.random.RandomState(CONVERT_SEED)
        mel = rs.randn(2, enc_cfg.n_mels, 160).astype(np.float32)
        mel[1, :, 100:] = 0.0
        lengths = [160, 100]
        with torch.no_grad():
            want, want_len = tiny_oracle(torch.from_numpy(mel), torch.tensor(lengths))
            got, got_len = tiny_enc(torch.from_numpy(mel).to(device),
                                    torch.tensor(lengths, dtype=torch.int32, device=device))
        check(got_len.tolist() == want_len.tolist(), ".nemo tar: encoder lengths differ")
        tiny_rel = valid_rel_l2(got.cpu(), want, want_len.tolist())
        check(tiny_rel <= ORACLE_TOL, f".nemo tar: encoder vs NeMo oracle rel L2 {tiny_rel}")
        print(f"phase 20 .nemo tar (test-tiny, model_config.yaml with n_layers "
              f"{deeper.n_layers}): PyYAML {'present: the yaml applied' if have_yaml else 'absent: the preset kept, as JAX does'} "
              f"({n_layers} blocks); every key consumed on the card; f32 encoder on the card vs "
              f"the NeMo oracle on the CPU rel L2 {tiny_rel:.3e}", flush=True)

        # -- the converted v3, served in bf16 and int8
        keys = {name: npz_key_count(p) for name, p in parts.items()}
        for quantization, label in (("none", "bf16"), ("int8", "int8")):
            models, manager, launches, line = v3_requests(
                attn, i8, device, quantization, checkpoint_dir=tmp / "v3",
                seconds=CONVERTED_REQUEST_S)
            if quantization == "none":
                for name, module in (("encoder", models.encoder), ("predictor", models.predictor),
                                     ("joint", models.joint)):
                    check(len(module.state_dict()) == keys[name],
                          f"converted {name}: {keys[name]} npz keys, "
                          f"{len(module.state_dict())} in the module")
                audio = speechlike(np.random.RandomState(CONVERT_SEED), 15.0)
                manager.transcribe(audio)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    manager.transcribe(audio)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                kernels, busy = device_activity(prof)
                timing = (f"timing [{smi}] converted v3 bf16, one 15 s request: {wall:.3f} ms "
                          f"(host wall, profiled), {kernels} kernel launches, {busy:.3f} ms "
                          f"device busy, idle share {max(0.0, 1 - busy / wall):.3f}")
            print(f"phase 20 converted {line} | npz keys {keys}, each consumed", flush=True)
            paths[f"converted v3 {label}, 3 x 15 s (phase 20)"] = launches
            del models, manager
            torch.cuda.empty_cache()
        print(timing, flush=True)

        # -- the converted f32 encoder against the NeMo oracle on the raw weights
        models = AsrModels.load("v3", checkpoint_dir=tmp / "v3", device=device,
                                allow_random_init=False, dtype="float32")
        rs = np.random.RandomState(CONVERT_SEED + 2)
        audio_len = [WINDOW, 160_000]
        audio = torch.from_numpy(np.stack([speechlike(rs, 15.0) for _ in audio_len])).to(device)
        mel, mel_len = models.mel(audio, torch.tensor(audio_len, dtype=torch.int32, device=device))
        mel = mel.float() * (torch.arange(mel.shape[-1], device=device)[None, None, :]
                             < mel_len[:, None, None])
        (got, got_len), c = counted(attn, i8, lambda: models.encoder(mel, mel_len))
        check(c["relpos_attention"] == spec.conformer.n_layers and c["int8_matmul_fused"] == 0,
              f"converted f32 encoder: launches {c}")
        with torch.no_grad():
            want, want_len = oracle(mel, mel_len.long())
        check(got_len.tolist() == want_len.tolist(), "converted f32 encoder: lengths differ")
        rel = valid_rel_l2(got, want, want_len.tolist())
        check(rel <= ORACLE_TOL, f"converted f32 encoder vs the NeMo oracle: rel L2 {rel}")
        paths["converted v3 f32 encoder vs NeMo oracle (phase 20)"] = c
        print(f"phase 20 converted v3 f32 encoder (the f32 attention kernel at Dh "
              f"{spec.conformer.head_dim}, TF32 off) vs the NeMo oracle on the raw state dict, "
              f"on the card, 15 s x 2 ragged: relative L2 {rel:.3e} over valid frames (tol "
              f"{ORACLE_TOL:g}), launches {c}", flush=True)
        del models, oracle
        torch.cuda.empty_cache()

        # -- Supertonic-3: a staged ONNX release converted in place
        release = tmp / "supertonic3"
        truth = synthesize_supertonic3_fixture(release, SUPERTONIC3_TEST, seed=CONVERT_SEED)

        def staged():
            t0 = time.perf_counter()
            mgr = Supertonic3Manager(SUPERTONIC3_TEST, checkpoint_dir=release, device=device)
            load_s = time.perf_counter() - t0
            return mgr, load_s, mgr.synthesize(SUPERTONIC_TEXT, "F1", "en", seed=5)

        (mgr, load_s, res), c = counted(attn, i8, staged)
        check(all((release / f"{stage}.npz").exists() for stage in STAGES),
              "Supertonic-3: the release was not converted in place")
        for stage, module in (("text_encoder", mgr.text_enc), ("duration_predictor", mgr.dur_pred),
                              ("vector_estimator", mgr.estimator), ("vocoder", mgr.vocoder)):
            want_state = from_jax_params(truth[stage])
            own = module.state_dict()
            check(set(own) == set(want_state) and all(
                torch.equal(own[k].cpu(), torch.as_tensor(v)) for k, v in want_state.items()),
                f"Supertonic-3 {stage}: the manager does not hold the release's weights")
        check(bool(np.isfinite(res.samples).all()) and res.samples.size > 0,
              "Supertonic-3: samples not finite")
        check(c["relpos_attention"] == 0 and c["int8_matmul_fused"] == 0,
              f"Supertonic-3: launches {c}")
        paths["Supertonic-3 converted in place (phase 20)"] = c
        print(f"phase 20 Supertonic-3 (SUPERTONIC3_TEST) staged ONNX release with no npz: "
              f"converted in place and loaded in {load_s:.2f} s, every stage holds the release's "
              f"weights; {res.duration:.2f} s of audio, finite; launches {c}", flush=True)
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from fluidaudio_tpu_torch.ops import attention as attn
    from fluidaudio_tpu_torch.ops import int8_matmul as i8

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    elapsed = lambda done: print(f"elapsed {time.perf_counter() - t0:.1f} s after {done}",
                                 flush=True)
    smi, builds = phase_device(attn, i8)
    attn_err = phase_kernel_parity(attn, device)
    int8_err = phase_int8_parity(i8, device)
    phase_trained_fixture(device)
    elapsed("phases 1-4")
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
    elapsed("phases 5-7")
    phase_streaming_fixtures(attn, i8, device)
    streaming_full_width(attn, i8, device, smi)
    elapsed("phases 8-9")
    phase_repairs(attn, i8, device, builds)
    paths = {"trained fixtures (phase 11)": phase_facade_fixtures(attn, i8, device)}
    elapsed("phases 10-11")
    paths["keyword spotter 0.6B, 40 s"], _ = phase_spotter_full_width(attn, i8, device, smi)
    paths.update(phase_facades_full_width(attn, i8, device, smi))
    elapsed("phase 12")
    paths["registry (phase 13)"] = phase_registry(attn, i8, device)
    elapsed("phase 13")
    paths.update(phase_family_fixtures(attn, i8, device))
    elapsed("phase 14")
    paths.update(phase_families_full_width(attn, i8, device, smi))
    elapsed("phase 15")
    diar_paths, diar_err, _ = phase_diarizers(attn, i8, device, smi)
    paths.update(diar_paths)
    elapsed("phase 16")
    paths.update(phase_tts_lseend_itn(attn, i8, device, smi)[0])
    elapsed("phase 17")
    paths.update(phase_tts_rest(attn, i8, device, smi)[0])
    elapsed("phase 18")
    paths.update(phase_cli(attn, i8, device, smi)[0])
    elapsed("phase 19")
    paths.update(phase_convert(attn, i8, device, smi))
    elapsed("phase 20")
    print(json.dumps({"kernels": [{
        "name": "relpos_attention",
        "route": "cuda",
        "source": "fluidaudio_tpu_torch/csrc/relpos_attention.cu",
        "replaces": "fluidaudio_tpu/ops/attention_pallas.py:151",
        "launches": bf16_launches["relpos_attention"],
        "max_abs_err": attn_err,
        **attn_t,
        "launches_by_path": {k: v["relpos_attention"] for k, v in paths.items()},
        "plain_calls_by_path": {k: v["relpos_attention_plain calls"] for k, v in paths.items()
                                if v["relpos_attention_plain calls"]},
        "max_abs_err_sortformer_shapes_bf16": diar_err,
    }, {
        "name": "int8_matmul_fused",
        "route": "cuda",
        "source": "fluidaudio_tpu_torch/csrc/int8_matmul_fused.cu",
        "replaces": "fluidaudio_tpu/ops/quant_pallas.py:107",
        "launches": int8_launches["int8_matmul_fused"],
        "max_abs_err": int8_err,
        **int8_t,
        "launches_by_path": {k: v["int8_matmul_fused"] for k, v in paths.items()},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
