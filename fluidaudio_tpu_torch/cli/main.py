"""CLI dispatcher of the PyTorch port: `python -m fluidaudio_tpu_torch.cli`.

Port of `fluidaudio_tpu/cli/main.py` (reference `FluidAudioCLI.swift:32-108`,
~35 commands, with the peak-RSS report on exit, :183-221): the same
subcommands, arguments, defaults and printed JSON keys, over the port's
managers. Where JAX prints its backend and version, the port prints the
torch device type and `"torch": torch.__version__`.

`--device` (before the subcommand) picks the device: by default the card
(`utils/device.py::resolve_device`); without one the command exits 1 with
the reason, naming `--device cpu`, and never runs on the CPU unasked.
Every command passes the resolved device to each manager, model load and
fixture it builds (`device=`). Each command imports its managers inside its
body from their canonical modules, as in JAX.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from pathlib import Path

import numpy as np


def cmd_transcribe(args: argparse.Namespace) -> int:
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.zoo import AsrModels

    models = AsrModels.load(args.version, allow_random_init=args.allow_random_init,
                            device=args.device)
    manager = AsrManager(models, ASRConfig(parallel_chunk_batch=args.batch))
    for path in args.audio:
        result = manager.transcribe(path)
        print(f"{path}: {result.text}")
        print(
            f"  duration {result.duration:.2f}s  rtfx {result.rtfx:.1f}x  "
            f"confidence {result.confidence:.3f}"
        )
    return 0


def cmd_vad_analyze(args: argparse.Namespace) -> int:
    from fluidaudio_tpu_torch.utils.converter import AudioConverter
    from fluidaudio_tpu_torch.vad.manager import VadManager
    from fluidaudio_tpu_torch.vad.types import VadConfig, VadSegmentationConfig

    manager = VadManager(VadConfig(default_threshold=args.threshold), device=args.device)
    conv = AudioConverter()
    for path in args.audio:
        samples = conv.resample_file(path)
        t0 = time.perf_counter()
        segments = manager.segment_speech(samples, VadSegmentationConfig())
        dt = time.perf_counter() - t0
        dur = samples.size / 16000
        print(f"{path}: {len(segments)} speech segments  ({dur:.1f}s audio, {dur/dt:.0f}x RT)")
        for seg in segments:
            print(f"  {seg.start_time:8.2f} - {seg.end_time:8.2f}  ({seg.duration:.2f}s)")
    return 0


def cmd_download(args: argparse.Namespace) -> int:
    from fluidaudio_tpu_torch.registry import DownloadUtils, Repo, repair_repo

    repo = Repo[args.repo.upper().replace("-", "_")]
    print(f"downloading {repo.spec.name} -> {DownloadUtils.repo_dir(repo)}")
    status = repair_repo(repo, getattr(args, "variant", None))
    print(f"{repo.folder_name}: {status.state} ({len(status.present)} artifacts)")
    return 0 if status.ready else 1


def cmd_doctor(args: argparse.Namespace) -> int:
    """Per-family asset readiness report (reference: per-manager
    requiredModels checks + loadWithAutoRecovery, surfaced as one command)."""
    import json as _json

    from fluidaudio_tpu_torch.registry import Repo, readiness_report, repair_repo

    if args.repair:
        repo = Repo[args.repair.upper().replace("-", "_")]
        status = repair_repo(repo)
        print(_json.dumps(status.to_dict(), indent=2))
        return 0 if status.ready else 1

    report = readiness_report(deep=not args.fast)
    if args.json:
        print(_json.dumps(report))
        return 0
    print(f"models dir: {report['models_dir']}   offline: {report['offline']}")
    print(f"families ready: {report['families_ready']}/{report['families_total']}\n")
    for key, fam in report["families"].items():
        mark = "✓" if fam["ready"] else "✗"
        print(f" {mark} {key:<22} {fam['label']}")
        for r in fam["repos"]:
            detail = ""
            if r["missing"]:
                detail = f"  missing: {', '.join(r['missing'][:4])}" + (
                    " …" if len(r["missing"]) > 4 else ""
                )
            if r["corrupt"]:
                detail += f"  CORRUPT: {', '.join(r['corrupt'])}"
            print(f"     [{r['state']:<10}] {r['repo']}{detail}")
    return 0


def cmd_multi_stream(args: argparse.Namespace) -> int:
    """Transcribe N files as one batch (reference multi-stream command)."""
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.zoo import AsrModels

    models = AsrModels.load(args.version, allow_random_init=args.allow_random_init,
                            device=args.device)
    manager = AsrManager(
        models, ASRConfig(parallel_chunk_batch=max(2, len(args.audio)))
    )
    t0 = time.perf_counter()
    results = [manager.transcribe(p) for p in args.audio]
    dt = time.perf_counter() - t0
    total = sum(r.duration for r in results)
    for path, r in zip(args.audio, results):
        print(f"{path}: {r.text[:80]}")
    print(f"total {total:.1f}s audio in {dt:.2f}s = {total/dt:.1f}x RT")
    return 0




def cmd_diarize(args: argparse.Namespace) -> int:
    from fluidaudio_tpu_torch.utils.converter import AudioConverter
    from fluidaudio_tpu_torch.metrics import write_rttm

    conv = AudioConverter()
    if args.mode == "offline":
        from fluidaudio_tpu_torch.diarizer.offline import OfflineDiarizerManager

        manager = OfflineDiarizerManager(device=args.device)
        process = manager.process
    elif args.mode == "sortformer":
        from fluidaudio_tpu_torch.diarizer.sortformer import SortformerDiarizer

        manager = SortformerDiarizer(device=args.device)
        process = manager.process
    elif args.mode == "lseend":
        from fluidaudio_tpu_torch.diarizer.lseend import LSEENDDiarizer

        manager = LSEENDDiarizer(device=args.device)
        process = manager.process
    else:
        from fluidaudio_tpu_torch.diarizer import DiarizerManager

        manager = DiarizerManager(device=args.device)
        process = manager.process

    for path in args.audio:
        samples = conv.resample_file(path)
        result = process(samples)
        dur = samples.size / 16000
        rtfx = dur / result.timings.total_seconds if result.timings.total_seconds else 0
        print(f"{path}: {len(result.segments)} segments, {result.speaker_count} speakers, {rtfx:.1f}x RT")
        if args.rttm:
            print(write_rttm(result.segments, Path(path).stem), end="")
        else:
            for seg in result.segments:
                print(f"  {seg.start_time:8.2f} - {seg.end_time:8.2f}  {seg.speaker_id}")
    return 0


def cmd_tts(args: argparse.Namespace) -> int:
    from fluidaudio_tpu_torch.tts import KokoroManager
    from fluidaudio_tpu_torch.utils.audio_io import write_wav

    manager = KokoroManager(variant=args.variant, device=args.device)
    t0 = time.perf_counter()
    if args.phoneme_input:
        result = manager.synthesize_from_phonemes(args.text, voice=args.voice)
    else:
        result = manager.synthesize(args.text, voice=args.voice)
    dt = time.perf_counter() - t0
    write_wav(args.output, result.samples, result.sample_rate)
    rtfx = result.duration / dt if dt else 0
    print(f"{args.output}: {result.duration:.2f}s @ {result.sample_rate} Hz ({rtfx:.1f}x RT)")
    return 0


def cmd_normalize(args: argparse.Namespace) -> int:
    from fluidaudio_tpu_torch.itn import TextNormalizer

    tn = TextNormalizer(args.language)
    print(tn.normalize_sentences(" ".join(args.text)))
    return 0


def cmd_tts_asr_verify(args: argparse.Namespace) -> int:
    """TTS -> ASR round-trip consistency check (reference tts-asr-verify)."""
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.zoo import AsrModels
    from fluidaudio_tpu_torch.tts import KokoroManager, tts_asr_roundtrip

    if args.trained_fixture:
        # hermetic mode: both ends are the committed trained tiny fixtures
        # (tone-word language) — works with zero downloaded assets
        from fluidaudio_tpu_torch.train import fixtures as fx

        tts = fx.load_tts_manager(device=args.device)
        asr = AsrManager(AsrModels.load(
            "test-tiny", checkpoint_dir=fx.trained_assets_dir() / "asr",
            allow_random_init=False, device=args.device))
        result = tts_asr_roundtrip(tts, asr, args.text)
        print(f"text:       {result.text}")
        print(f"transcript: {result.transcript}")
        print(f"wer: {result.wer:.3f}  audio: {result.audio_seconds:.2f}s")
        return 0 if result.wer <= args.max_wer else 1

    tts = KokoroManager(device=args.device)
    asr = AsrManager(AsrModels.load(args.version, allow_random_init=args.allow_random_init,
                                    device=args.device))
    result = tts_asr_roundtrip(tts, asr, args.text, voice=args.voice)
    print(f"text:       {result.text}")
    print(f"transcript: {result.transcript}")
    print(f"wer: {result.wer:.3f}  audio: {result.audio_seconds:.2f}s")
    return 0 if result.wer <= args.max_wer else 1


def cmd_benchmark(args: argparse.Namespace) -> int:
    """Synthetic-throughput benchmarks per workload (one JSON line each).

    JAX's version first turns on XLA's persistent compilation cache
    (`utils/compilation_cache.py`); the port compiles no XLA programs, so it
    has no such cache and makes no such call. The ASR workload calls
    `build_pipeline(B)` once to warm up, then times 3 calls, synchronising
    the card after the warm-up and before reading the clock."""
    import torch

    rng = np.random.RandomState(0)
    results = []

    def sync() -> None:
        if args.device.type == "cuda":
            torch.cuda.synchronize(args.device)

    if args.workload in ("asr", "all"):
        from fluidaudio_tpu_torch.asr.manager import AsrManager
        from fluidaudio_tpu_torch.models.zoo import AsrModels

        models = AsrModels.load("v3", allow_random_init=True, device=args.device)
        manager = AsrManager(models)
        B, W = args.batch, 240_000
        fn = manager.build_pipeline(B)
        audio = torch.from_numpy(rng.randn(B, W).astype(np.float32) * 0.1).to(args.device)
        lengths = torch.full((B,), W, dtype=torch.int32, device=args.device)
        out, _ = fn(audio, lengths)
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            out, _ = fn(audio, lengths)
        sync()
        dt = (time.perf_counter() - t0) / 3
        results.append({"metric": "asr_batch_rtfx", "value": round(B * 15 / dt, 1),
                        "unit": "x_realtime"})

    if args.workload in ("vad", "all"):
        from fluidaudio_tpu_torch.vad.manager import VadManager

        vm = VadManager(device=args.device)
        audio = (rng.randn(16000 * 60) * 0.1).astype(np.float32)
        vm.process(audio)  # warm
        t0 = time.perf_counter()
        vm.process(audio)
        dt = time.perf_counter() - t0
        results.append({"metric": "vad_rtfx", "value": round(60 / dt, 1),
                        "unit": "x_realtime"})

    if args.workload in ("streaming", "all"):
        from fluidaudio_tpu_torch.asr.streaming_eou import StreamingEouAsrManager

        mgr = StreamingEouAsrManager(chunk_ms=320, device=args.device)
        state = mgr.make_state()
        chunk = (rng.randn(5360) * 0.1).astype(np.float32)
        mgr.process(chunk, state)  # warm/compile
        latencies = []
        for _ in range(20):
            t0 = time.perf_counter()
            mgr.process(chunk, state)
            latencies.append(time.perf_counter() - t0)
        p50 = sorted(latencies)[len(latencies) // 2] * 1e3
        results.append({"metric": "eou_streaming_p50_chunk_latency",
                        "value": round(p50, 2), "unit": "ms_per_320ms_chunk"})

    if args.workload in ("diarizer", "all"):
        from fluidaudio_tpu_torch.diarizer.sortformer import SortformerDiarizer

        sd = SortformerDiarizer(device=args.device)
        audio = (rng.randn(16000 * 31) * 0.1).astype(np.float32)
        sd.process_offline(audio)  # warm
        t0 = time.perf_counter()
        sd.process_offline(audio)
        dt = time.perf_counter() - t0
        results.append({"metric": "sortformer_offline_rtfx", "value": round(31 / dt, 1),
                        "unit": "x_realtime"})

    for r in results:
        print(json.dumps(r))
    return 0


def _peak_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main(argv: list[str] | None = None) -> int:
    from fluidaudio_tpu_torch.utils.device import resolve_device

    parser = argparse.ArgumentParser(prog="fluidaudio",
                                     description="audio AI CLI (PyTorch port)")
    parser.add_argument("--device", default=None,
                        help="torch device to run on, e.g. cpu, cuda, cuda:1 "
                             "(default: the first CUDA device)")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("transcribe", help="batch ASR on audio files")
    p.add_argument("audio", nargs="+")
    p.add_argument("--version", default="v3")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--allow-random-init", action="store_true")
    p.set_defaults(fn=cmd_transcribe)

    p = sub.add_parser("multi-stream", help="transcribe N files in parallel")
    p.add_argument("audio", nargs="+")
    p.add_argument("--version", default="v3")
    p.add_argument("--allow-random-init", action="store_true")
    p.set_defaults(fn=cmd_multi_stream)

    p = sub.add_parser("vad-analyze", help="voice activity segmentation")
    p.add_argument("audio", nargs="+")
    p.add_argument("--threshold", type=float, default=0.85)
    p.set_defaults(fn=cmd_vad_analyze)

    p = sub.add_parser("doctor", help="per-family model asset readiness report")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--fast", action="store_true",
                   help="existence checks only (skip npz/json validation)")
    p.add_argument("--repair", metavar="REPO",
                   help="repair one repo's cache (fetch missing, refetch corrupt)")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("download", help="fetch model assets into the cache")
    p.add_argument("repo")
    p.add_argument("--variant", help="family variant (e.g. offline, t128, int8)")
    p.set_defaults(fn=cmd_download)


    p = sub.add_parser("diarize", help="speaker diarization")
    p.add_argument("audio", nargs="+")
    p.add_argument("--mode", choices=["online", "offline", "sortformer", "lseend"],
                   default="offline")
    p.add_argument("--rttm", action="store_true")
    p.set_defaults(fn=cmd_diarize)

    p = sub.add_parser("tts", help="synthesize speech")
    p.add_argument("text")
    p.add_argument("--voice", default=None,
                   help="voice id (default: variant's default voice)")
    p.add_argument("--variant", choices=["english", "mandarin", "japanese"],
                   default="english")
    p.add_argument("--phoneme-input", action="store_true",
                   help="treat TEXT as pre-computed IPA/bopomofo phonemes "
                        "(required for the japanese variant)")
    p.add_argument("--output", default="out.wav")
    p.set_defaults(fn=cmd_tts)

    p = sub.add_parser("normalize", help="inverse text normalization")
    p.add_argument("text", nargs="+")
    p.add_argument("--language", default="en")
    p.set_defaults(fn=cmd_normalize)

    p = sub.add_parser("tts-asr-verify", help="TTS->ASR round-trip check")
    p.add_argument("text")
    p.add_argument("--voice", default="af_heart")
    p.add_argument("--version", default="v3")
    p.add_argument("--max-wer", type=float, default=1.0)
    p.add_argument("--allow-random-init", action="store_true")
    p.add_argument("--trained-fixture", action="store_true",
                   help="hermetic mode on the committed trained tiny "
                        "fixtures (tone-word language, e.g. 'w3 w7 w1')")
    p.set_defaults(fn=cmd_tts_asr_verify)

    p = sub.add_parser("benchmark", help="synthetic throughput benchmarks")
    p.add_argument("--workload", choices=["asr", "vad", "diarizer", "streaming", "all"], default="asr")
    p.add_argument("--batch", type=int, default=32)
    p.set_defaults(fn=cmd_benchmark)

    from fluidaudio_tpu_torch.cli.benchmarks import register as register_benchmarks
    from fluidaudio_tpu_torch.cli.families import register as register_families

    register_benchmarks(sub)
    register_families(sub)

    args = parser.parse_args(argv)
    try:
        args.device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"fluidaudio: {e}; on the command line: --device cpu", file=sys.stderr)
        return 1
    try:
        code = args.fn(args)
    finally:
        print(f"peak memory: {_peak_rss_mb():.1f} MB", file=sys.stderr)
    return code


if __name__ == "__main__":
    sys.exit(main())
