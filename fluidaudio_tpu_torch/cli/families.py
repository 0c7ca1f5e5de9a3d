"""Per-family CLI commands of the PyTorch port: transcribe/process entry
points and WER/CER/DER benchmarks for the non-flagship model families.

Port of `fluidaudio_tpu/cli/families.py` (the reference dispatcher's
per-family commands, `FluidAudioCLI.swift:32-108`: sensevoice-transcribe,
paraformer-transcribe, cohere-transcribe, nemotron-transcribe,
nemotron-multilingual-transcribe, parakeet-eou, sortformer, lseend, process,
plus the benchmark harnesses `SenseVoiceBenchmark.swift`,
`CohereBenchmark.swift`, `NemotronBenchmark.swift`,
`NemotronMultilingualFleursBenchmark.swift`, `MultiStreamBench.swift`,
`UnifiedBenchmark.swift`, `LSEENDBenchmark.swift`,
`JapaneseAsrBenchmark.swift`, `G2PBenchmark.swift`): the same arguments,
defaults and printed JSON keys. Dataset downloads are egress-gated, so the
benchmarks consume local directories in the layouts `download-dataset`
stages. Every command runs on the CLI's `--device` (`cli/main.py`).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from fluidaudio_tpu_torch.cli.benchmarks import _iter_librispeech, _pair_rttm


# --------------------------------------------------------------- helpers


def _wer_over(utts, transcribe, *, use_cer: bool = False, verbose: bool = False,
              extra: dict | None = None) -> int:
    """Shared WER/CER harness: `transcribe(wav_path) -> (text, audio_seconds)`."""
    from fluidaudio_tpu_torch.metrics.text_normalizer import normalize_for_scoring
    from fluidaudio_tpu_torch.metrics.wer import WerBreakdown, cer, levenshtein

    agg = WerBreakdown(0, 0, 0, 0, 0)
    total_audio = total_wall = 0.0
    n = 0
    for utt_id, wav, ref in utts:
        t0 = time.perf_counter()
        text, audio_s = transcribe(wav)
        wall = time.perf_counter() - t0
        if use_cer:
            b = cer(normalize_for_scoring(ref), normalize_for_scoring(text))
        else:
            b = levenshtein(
                normalize_for_scoring(ref).split(),
                normalize_for_scoring(text).split(),
            )
        agg = WerBreakdown(
            agg.errors + b.errors, agg.substitutions + b.substitutions,
            agg.insertions + b.insertions, agg.deletions + b.deletions,
            agg.reference_length + b.reference_length,
        )
        total_audio += audio_s
        total_wall += wall
        n += 1
        if verbose:
            print(f"  {utt_id}: {'cer' if use_cer else 'wer'} {b.rate*100:.2f}%  "
                  f"rtfx {audio_s/max(wall,1e-9):.1f}x")
    summary = {
        "files": n,
        ("cer_pct" if use_cer else "wer_pct"): round(agg.rate * 100, 3),
        "audio_seconds": round(total_audio, 2),
        "rtfx": round(total_audio / max(total_wall, 1e-9), 1),
        **(extra or {}),
    }
    print(json.dumps(summary))
    return 0


def _load_utts(args) -> list | None:
    """(utt_id, wav, ref) triples from a LibriSpeech- OR FLEURS-layout dir
    (the multilingual benchmarks document FLEURS trees; both parse here)."""
    from fluidaudio_tpu_torch.cli.benchmarks import _iter_fleurs

    root = Path(args.dataset_dir)
    utts = list(_iter_librispeech(root))
    if not utts:
        utts = [(f"{lang}/{utt_id}", wav, text)
                for lang, utt_id, wav, text in _iter_fleurs(root)]
    if getattr(args, "max_files", 0):
        utts = utts[: args.max_files]
    if not utts:
        print(f"no utterances under {args.dataset_dir} "
              "(LibriSpeech layout *.trans.txt + <utt>.wav, or FLEURS "
              "layout <lang>/test.tsv + wavs)")
        return None
    return utts


def _read_audio(path) -> "tuple":
    from fluidaudio_tpu_torch.utils.converter import AudioConverter

    samples = AudioConverter().resample_file(path)
    return samples, samples.size / 16000.0


# ------------------------------------------------- non-AR family transcribe


def _simple_transcribe(make_manager, paths, device, **kw) -> int:
    manager = make_manager(device=device)
    for path in paths:
        samples, dur = _read_audio(path)
        t0 = time.perf_counter()
        result = manager.transcribe(samples, **kw)
        wall = time.perf_counter() - t0
        print(f"{path}: {result.text}")
        print(f"  duration {dur:.2f}s  rtfx {dur/max(wall,1e-9):.1f}x")
    return 0


def cmd_sensevoice_transcribe(args: argparse.Namespace) -> int:
    from fluidaudio_tpu_torch.asr.sensevoice_manager import SenseVoiceManager

    return _simple_transcribe(SenseVoiceManager, args.audio, args.device,
                              language=args.language)


def cmd_paraformer_transcribe(args: argparse.Namespace) -> int:
    from fluidaudio_tpu_torch.asr.paraformer_manager import ParaformerManager

    return _simple_transcribe(ParaformerManager, args.audio, args.device)


def cmd_cohere_transcribe(args: argparse.Namespace) -> int:
    from fluidaudio_tpu_torch.asr.cohere_manager import CoherePipeline

    return _simple_transcribe(CoherePipeline, args.audio, args.device)


# ------------------------------------------------------ streaming families


def _stream_file(manager, path, chunk_s: float = 1.0) -> tuple[str, float]:
    """Feed a file through a make_state/process/finish streaming manager."""
    samples, dur = _read_audio(path)
    state = manager.make_state()
    finals: list[str] = []
    step = int(16000 * chunk_s)
    for off in range(0, samples.size, step):
        for r in manager.process(samples[off : off + step], state):
            if r.is_final:
                finals.append(r.text)
    tail = manager.finish(state)
    if tail.text:
        finals.append(tail.text)
    return " ".join(t for t in finals if t).strip(), dur


def cmd_nemotron_transcribe(args: argparse.Namespace) -> int:
    manager = _make_nemotron(args)
    for path in args.audio:
        t0 = time.perf_counter()
        text, dur = _stream_file(manager, path)
        wall = time.perf_counter() - t0
        print(f"{path}: {text}")
        print(f"  duration {dur:.2f}s  rtfx {dur/max(wall,1e-9):.1f}x")
    return 0


def _make_nemotron(args, multilingual: bool | None = None):
    from fluidaudio_tpu_torch.asr.streaming_nemotron import (
        NEMOTRON_EN,
        NEMOTRON_MULTI_FULL,
        NEMOTRON_MULTI_LATIN,
        StreamingNemotronAsrManager,
    )

    multilingual = args.multilingual if multilingual is None else multilingual
    if multilingual:
        spec = (NEMOTRON_MULTI_LATIN if getattr(args, "latin", False)
                else NEMOTRON_MULTI_FULL)
    else:
        spec = NEMOTRON_EN
    return StreamingNemotronAsrManager(
        spec, chunk_ms=args.chunk_ms, language=getattr(args, "language", "auto"),
        device=args.device,
    )


def cmd_parakeet_eou(args: argparse.Namespace) -> int:
    from fluidaudio_tpu_torch.asr.streaming_eou import StreamingEouAsrManager

    manager = StreamingEouAsrManager(chunk_ms=args.chunk_ms, device=args.device)
    for path in args.audio:
        samples, dur = _read_audio(path)
        state = manager.make_state()
        t0 = time.perf_counter()
        step = 16000
        utt_start = 0  # state.tokens is CUMULATIVE; segment at EOU marks
        for off in range(0, samples.size, step):
            for r in manager.process(samples[off : off + step], state):
                if r.eou_detected:
                    utt = manager.tokenizer.decode(state.tokens[utt_start:])
                    utt_start = len(state.tokens)
                    if utt:
                        print(f"  [eou] {utt}")
        tail = manager.finish(state)
        wall = time.perf_counter() - t0
        print(f"{path}: {tail.text}")
        print(f"  duration {dur:.2f}s  rtfx {dur/max(wall,1e-9):.1f}x")
    return 0


def _diarize_files(make_manager, paths, rttm: bool, device) -> int:
    from fluidaudio_tpu_torch.metrics import write_rttm

    manager = make_manager(device=device)
    for path in paths:
        samples, dur = _read_audio(path)
        t0 = time.perf_counter()
        result = manager.process(samples)
        wall = time.perf_counter() - t0
        print(f"{path}: {len(result.segments)} segments, "
              f"{result.speaker_count} speakers, {dur/max(wall,1e-9):.1f}x RT")
        if rttm:
            print(write_rttm(result.segments, Path(path).stem), end="")
        else:
            for seg in result.segments:
                print(f"  {seg.start_time:8.2f} - {seg.end_time:8.2f}  {seg.speaker_id}")
    return 0


def cmd_sortformer(args: argparse.Namespace) -> int:
    from fluidaudio_tpu_torch.diarizer.sortformer import SortformerDiarizer

    return _diarize_files(SortformerDiarizer, args.audio, args.rttm, args.device)


def cmd_lseend(args: argparse.Namespace) -> int:
    from fluidaudio_tpu_torch.diarizer.lseend import LSEENDDiarizer

    return _diarize_files(
        lambda **kw: LSEENDDiarizer(step_ms=args.step_ms, variant=args.variant, **kw),
        args.audio, args.rttm, args.device,
    )


def cmd_process(args: argparse.Namespace) -> int:
    """Offline diarization (reference `process` command)."""
    from fluidaudio_tpu_torch.diarizer.offline import OfflineDiarizerManager

    return _diarize_files(OfflineDiarizerManager, args.audio, args.rttm, args.device)


# ------------------------------------------------------------- benchmarks


def cmd_sensevoice_benchmark(args: argparse.Namespace) -> int:
    from fluidaudio_tpu_torch.asr.sensevoice_manager import SenseVoiceManager

    utts = _load_utts(args)
    if utts is None:
        return 1
    manager = SenseVoiceManager(device=args.device)

    def run(wav):
        samples, dur = _read_audio(wav)
        return manager.transcribe(samples, language=args.language).text, dur

    return _wer_over(utts, run, use_cer=args.cer, verbose=args.verbose,
                     extra={"family": "sensevoice", "language": args.language})


def cmd_cohere_benchmark(args: argparse.Namespace) -> int:
    from fluidaudio_tpu_torch.asr.cohere_manager import CoherePipeline

    utts = _load_utts(args)
    if utts is None:
        return 1
    manager = CoherePipeline(device=args.device)

    def run(wav):
        samples, dur = _read_audio(wav)
        return manager.transcribe(samples).text, dur

    return _wer_over(utts, run, verbose=args.verbose, extra={"family": "cohere"})


def cmd_nemotron_benchmark(args: argparse.Namespace) -> int:
    utts = _load_utts(args)
    if utts is None:
        return 1
    manager = _make_nemotron(args)

    def run(wav):
        return _stream_file(manager, wav)

    return _wer_over(
        utts, run, verbose=args.verbose,
        extra={"family": manager.spec.name, "chunk_ms": args.chunk_ms},
    )


def cmd_nemotron_multi_stream_bench(args: argparse.Namespace) -> int:
    """Throughput of N concurrent multilingual Nemotron streams
    (reference `NemotronMultilingualMultiStreamBench.swift`): N managers fed
    round-robin; wall-clock covers all streams."""
    paths = args.audio * args.repeat
    # ONE manager, one externalized state per stream: per-stream managers
    # would copy the 0.6B encoder params N times and recompile N chunk steps
    mgr = _make_nemotron(args, multilingual=True)
    audio = [_read_audio(p) for p in paths]
    t0 = time.perf_counter()
    texts = []
    for samples, _ in audio:
        state = mgr.make_state()
        mgr.process(samples, state)
        texts.append(mgr.finish(state).text)
    wall = time.perf_counter() - t0
    total = sum(d for _, d in audio)
    print(json.dumps({
        "streams": len(paths),
        "audio_seconds": round(total, 2),
        "rtfx_aggregate": round(total / max(wall, 1e-9), 1),
    }))
    return 0


def cmd_nemotron_multilingual_fleurs(args: argparse.Namespace) -> int:
    """Per-language streaming WER/CER for the multilingual Nemotron model
    over a staged FLEURS tree (reference
    `NemotronMultilingualFleursBenchmark.swift`, 892 LoC; baseline rows
    BASELINE.md "Nemotron multilingual FLEURS").

    Scoring matches NVIDIA's multilingual pipeline exactly as the reference
    documents it:
      * CJK / no-space scripts -> character-level WER (`metrics.cjk_chars`)
      * English -> the full English scoring normalizer
      * other Latin scripts -> Whisper-basic normalizer + digit spell-out
        ITN on BOTH sides (fr/de/es/it/pt, `metrics/spellout.py`)
    Prompt conditioning: FLEURS code -> prompt key
    (`fleurs_to_multilingual_language`), `--prompt-override` for regional
    A/Bs, `--forced-prefix` seeds the decoder with the `<xx-XX>` tag token
    (Whisper-style hard language lock). `--dump-samples` writes per-sample
    JSONL with raw + normalized hyp/ref and per-sample WER variants."""
    from fluidaudio_tpu_torch.asr.streaming_nemotron import fleurs_to_multilingual_language
    from fluidaudio_tpu_torch.cli.benchmarks import _iter_fleurs
    from fluidaudio_tpu_torch.metrics.spellout import SUPPORTED_LANGUAGES
    from fluidaudio_tpu_torch.metrics.text_normalizer import (
        basic_normalize,
        cjk_chars,
        is_cjk_language,
        normalize_for_scoring,
    )
    from fluidaudio_tpu_torch.metrics.wer import levenshtein

    root = Path(args.dataset_dir)
    by_lang: dict[str, list] = {}
    if args.dataset == "librispeech":
        for utt_id, wav, ref in _iter_librispeech(root):
            by_lang.setdefault("en_us", []).append((utt_id, wav, ref))
    elif args.dataset == "earnings22":
        data = root / "test-dataset"
        for wav in sorted(data.glob("*.wav")) if data.is_dir() else []:
            ref_file = wav.with_suffix("").with_suffix(".text.txt")
            if not ref_file.exists():
                ref_file = Path(str(wav)[: -len(".wav")] + ".text.txt")
            if ref_file.exists():
                by_lang.setdefault("en_us", []).append(
                    (wav.stem, wav, ref_file.read_text().strip()))
    else:
        for lang, utt_id, wav, ref in _iter_fleurs(root):
            by_lang.setdefault(lang, []).append((utt_id, wav, ref))

    languages = (args.languages.split(",") if args.languages
                 else sorted(by_lang))
    if args.max_files:
        by_lang = {k: v[: args.max_files] for k, v in by_lang.items()}
    if not any(by_lang.get(lang) for lang in languages):
        print(f"no samples under {root} for languages {languages}")
        return 1

    mgr = _make_nemotron(args, multilingual=True)
    dump = open(args.dump_samples, "w") if args.dump_samples else None

    def score(lang: str, hyp: str, ref: str) -> tuple[float, float]:
        """(per-sample wer, cer) under the language's scoring rules."""
        if is_cjk_language(lang):
            h, r = cjk_chars(hyp), cjk_chars(ref)
            w = levenshtein(r, h).rate
            return w, w
        if lang.lower().startswith("en"):
            h, r = normalize_for_scoring(hyp), normalize_for_scoring(ref)
        else:
            spell = lang.split("_")[0].split("-")[0].lower()
            spell = spell if spell in SUPPORTED_LANGUAGES else None
            h = basic_normalize(hyp, spell_out_lang=spell)
            r = basic_normalize(ref, spell_out_lang=spell)
        w = levenshtein(r.split(), h.split()).rate
        c = levenshtein(list(r.replace(" ", "")), list(h.replace(" ", ""))).rate
        return w, c

    results: dict[str, dict] = {}
    for lang in languages:
        samples = by_lang.get(lang) or []
        if not samples:
            continue
        prompt = args.prompt_override or fleurs_to_multilingual_language(lang)
        mgr.set_language(prompt)
        forced = mgr.lang_tag_token(prompt) if args.forced_prefix else None
        tot_w = tot_c = tot_audio = tot_wall = 0.0
        processed = skipped = 0
        detected: str | None = None
        for utt_id, wav, ref in samples:
            try:
                samples16, dur = _read_audio(wav)
            except Exception as e:
                print(f"  [{lang}] {utt_id}: resample failed ({e})")
                skipped += 1
                continue
            state = mgr.make_state(forced_prefix=forced)
            t0 = time.perf_counter()
            mgr.process(samples16, state)
            hyp = mgr.finish(state).text
            wall = time.perf_counter() - t0
            detected = detected or state.detected_language
            w, c = score(lang, hyp, ref)
            tot_w += w
            tot_c += c
            tot_audio += dur
            tot_wall += wall
            processed += 1
            if dump:
                spell = lang.split("_")[0].split("-")[0].lower()
                spell = spell if spell in SUPPORTED_LANGUAGES else None
                dump.write(json.dumps({
                    "sampleId": utt_id, "language": lang,
                    "audio_duration": round(dur, 3),
                    "detected_language": state.detected_language,
                    "hyp_raw": hyp, "ref_raw": ref,
                    "hyp_eng": normalize_for_scoring(hyp),
                    "ref_eng": normalize_for_scoring(ref),
                    "hyp_basic": basic_normalize(hyp),
                    "ref_basic": basic_normalize(ref),
                    "hyp_basic_itn": basic_normalize(hyp, spell_out_lang=spell),
                    "ref_basic_itn": basic_normalize(ref, spell_out_lang=spell),
                    "wer": round(w, 4), "cer": round(c, 4),
                }, ensure_ascii=False) + "\n")
            if args.verbose:
                print(f"  [{lang}] {utt_id}: wer {w*100:.1f}%")
        if processed:
            results[lang] = {
                "prompt": prompt,
                "wer_pct": round(100 * tot_w / processed, 2),
                "cer_pct": round(100 * tot_c / processed, 2),
                "rtfx": round(tot_audio / max(tot_wall, 1e-9), 1),
                "processed": processed,
                "skipped": skipped,
                "detected_language": detected,
            }
            print(f"{lang} [{prompt}]: WER={results[lang]['wer_pct']}% "
                  f"CER={results[lang]['cer_pct']}% "
                  f"RTFx={results[lang]['rtfx']}x ({processed} processed"
                  f"{', ' + str(skipped) + ' skipped' if skipped else ''})")
    if dump:
        dump.close()
    if not results:
        print("no samples processed")
        return 1
    summary = {
        "languages": results,
        "macro_wer_pct": round(
            sum(v["wer_pct"] for v in results.values()) / len(results), 2),
        "macro_cer_pct": round(
            sum(v["cer_pct"] for v in results.values()) / len(results), 2),
        "dataset": args.dataset,
        "chunk_ms": args.chunk_ms,
        "forced_prefix": bool(args.forced_prefix),
    }
    if args.output:
        Path(args.output).write_text(json.dumps(summary, indent=2,
                                                ensure_ascii=False))
    print(json.dumps(summary, ensure_ascii=False))
    return 0


def cmd_unified_benchmark(args: argparse.Namespace) -> int:
    """Unified checkpoint in batch and pseudo-streaming modes
    (reference `UnifiedBenchmark.swift`)."""
    from fluidaudio_tpu_torch.asr.unified import UnifiedAsrManager

    utts = _load_utts(args)
    if utts is None:
        return 1
    manager = UnifiedAsrManager(device=args.device)

    def run(wav):
        samples, dur = _read_audio(wav)
        return manager.transcribe(samples).text, dur

    return _wer_over(utts, run, verbose=args.verbose, extra={"family": "unified"})


def cmd_ja_benchmark(args: argparse.Namespace) -> int:
    """Japanese CER benchmark (reference `JapaneseAsrBenchmark.swift`,
    JSUT layout = LibriSpeech-style transcripts scored by CER)."""
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.zoo import AsrModels

    utts = _load_utts(args)
    if utts is None:
        return 1
    models = AsrModels.load("tdt-ja", allow_random_init=args.allow_random_init,
                            device=args.device)
    manager = AsrManager(models, ASRConfig())

    def run(wav):
        r = manager.transcribe(wav)
        return r.text, r.duration

    return _wer_over(utts, run, use_cer=True, verbose=args.verbose,
                     extra={"family": "tdt-ja"})


def cmd_lseend_benchmark(args: argparse.Namespace) -> int:
    """LS-EEND DER vs RTTM references (reference `LSEENDBenchmark.swift`)."""
    from fluidaudio_tpu_torch.diarizer.lseend import LSEENDDiarizer
    from fluidaudio_tpu_torch.diarizer.metrics import compute_der
    from fluidaudio_tpu_torch.metrics.rttm import parse_rttm
    from fluidaudio_tpu_torch.utils.converter import AudioConverter

    pairs = list(_pair_rttm(Path(args.dataset_dir)))
    if args.max_files:
        pairs = pairs[: args.max_files]
    if not pairs:
        print(f"no wav+rttm pairs under {args.dataset_dir}")
        return 1
    manager = LSEENDDiarizer(step_ms=args.step_ms, variant=args.variant,
                             device=args.device)
    conv = AudioConverter()
    ders, total_audio, total_wall = [], 0.0, 0.0
    for wav, rttm in pairs:
        samples = conv.resample_file(wav)
        t0 = time.perf_counter()
        result = manager.process(samples)
        wall = time.perf_counter() - t0
        ref = parse_rttm(rttm)
        d = compute_der(ref, result.segments, collar=args.collar)
        ders.append(d.der)
        total_audio += samples.size / 16000
        total_wall += wall
        if args.verbose:
            print(f"  {wav.stem}: DER {d.der*100:.2f}%")
    print(json.dumps({
        "files": len(ders),
        "der_pct": round(sum(ders) / len(ders) * 100, 3),
        "rtfx": round(total_audio / max(total_wall, 1e-9), 1),
        "step_ms": args.step_ms, "variant": args.variant,
    }))
    return 0


def cmd_g2p_benchmark(args: argparse.Namespace) -> int:
    """Phoneme error rate over a lexicon TSV (`word<TAB>phonemes`), matching
    the reference `G2PBenchmark.swift` PER metric."""
    from fluidaudio_tpu_torch.metrics.wer import levenshtein
    from fluidaudio_tpu_torch.tts.g2p import MultilingualG2P

    rows = []
    for line in Path(args.lexicon).read_text().splitlines():
        line = line.strip()
        if line and "\t" in line:
            word, _, phones = line.partition("\t")
            rows.append((word, phones.split()))
    if args.max_files:
        rows = rows[: args.max_files]
    if not rows:
        print(f"no `word<TAB>phonemes` rows in {args.lexicon}")
        return 1
    g2p = MultilingualG2P(device=args.device)
    t0 = time.perf_counter()
    preds = g2p.phonemize_words([w for w, _ in rows], language=args.language)
    wall = time.perf_counter() - t0
    errors = ref_len = 0
    for (word, ref), hyp in zip(rows, preds):
        # seq2seq output carries no separators: when the hypothesis has
        # spaces score token-vs-token, otherwise fall back to
        # character-level against the joined reference (space-split of an
        # unsegmented string would make any near-miss score ~100% PER)
        if " " in hyp.strip():
            b = levenshtein(ref, hyp.split())
        else:
            b = levenshtein(list("".join(ref)), list(hyp))
        errors += b.errors
        ref_len += b.reference_length
        if args.verbose:
            print(f"  {word}: {hyp}  (ref {' '.join(ref)})")
    print(json.dumps({
        "words": len(rows),
        "per_pct": round(errors / max(ref_len, 1) * 100, 3),
        "ms_per_word": round(wall * 1e3 / len(rows), 2),
        "language": args.language,
    }))
    return 0


# ------------------------------------------------------------ registration


def register(sub) -> None:
    def common(p, *, dataset: bool = False):
        if dataset:
            p.add_argument("--dataset-dir", required=True)
            p.add_argument("--max-files", type=int, default=0)
            p.add_argument("--verbose", action="store_true")
        else:
            p.add_argument("audio", nargs="+")

    p = sub.add_parser("sensevoice-transcribe", help="SenseVoice multilingual ASR")
    common(p)
    p.add_argument("--language", default="auto")
    p.set_defaults(fn=cmd_sensevoice_transcribe)

    p = sub.add_parser("paraformer-transcribe", help="Paraformer zh ASR")
    common(p)
    p.set_defaults(fn=cmd_paraformer_transcribe)

    p = sub.add_parser("cohere-transcribe", help="Cohere encoder-decoder ASR")
    common(p)
    p.set_defaults(fn=cmd_cohere_transcribe)

    p = sub.add_parser("nemotron-transcribe", help="Nemotron streaming RNNT ASR")
    common(p)
    p.add_argument("--chunk-ms", type=int, default=2240)
    p.add_argument("--multilingual", action="store_true")
    p.add_argument("--latin", action="store_true",
                   help="with --multilingual: the 2828-vocab latin joint")
    p.add_argument("--language", default="auto")
    p.set_defaults(fn=cmd_nemotron_transcribe)

    p = sub.add_parser("parakeet-eou", help="streaming EOU ASR with utterance events")
    common(p)
    p.add_argument("--chunk-ms", type=int, default=320)
    p.set_defaults(fn=cmd_parakeet_eou)

    p = sub.add_parser("sortformer", help="Sortformer streaming diarization")
    common(p)
    p.add_argument("--rttm", action="store_true")
    p.set_defaults(fn=cmd_sortformer)

    p = sub.add_parser("lseend", help="LS-EEND streaming diarization")
    common(p)
    p.add_argument("--rttm", action="store_true")
    p.add_argument("--step-ms", type=int, default=500)
    p.add_argument("--variant", default="dih3")
    p.set_defaults(fn=cmd_lseend)

    p = sub.add_parser("process", help="offline diarization (VBx pipeline)")
    common(p)
    p.add_argument("--rttm", action="store_true")
    p.set_defaults(fn=cmd_process)

    p = sub.add_parser("sensevoice-benchmark", help="SenseVoice WER/CER benchmark")
    common(p, dataset=True)
    p.add_argument("--language", default="auto")
    p.add_argument("--cer", action="store_true")
    p.set_defaults(fn=cmd_sensevoice_benchmark)

    p = sub.add_parser("cohere-benchmark", help="Cohere WER benchmark")
    common(p, dataset=True)
    p.set_defaults(fn=cmd_cohere_benchmark)

    p = sub.add_parser("nemotron-benchmark", help="Nemotron streaming WER benchmark")
    common(p, dataset=True)
    p.add_argument("--chunk-ms", type=int, default=2240)
    p.add_argument("--multilingual", action="store_true")
    p.add_argument("--latin", action="store_true")
    p.add_argument("--language", default="auto")
    p.set_defaults(fn=cmd_nemotron_benchmark)

    p = sub.add_parser(
        "nemotron-multilingual-benchmark",
        help="multilingual Nemotron WER benchmark (FLEURS-style local dir)",
    )
    common(p, dataset=True)
    p.add_argument("--chunk-ms", type=int, default=2240)
    p.add_argument("--latin", action="store_true")
    p.add_argument("--language", default="auto")
    p.set_defaults(fn=cmd_nemotron_benchmark, multilingual=True)

    p = sub.add_parser(
        "nemotron-multilingual-fleurs",
        help="per-language streaming WER/CER over staged FLEURS "
             "(NVIDIA-parity scoring: CJK char-level, basic-normalizer + "
             "digit spell-out ITN for Latin languages)",
    )
    common(p, dataset=True)
    p.add_argument("--languages", default="",
                   help="comma-separated FLEURS codes (default: all staged)")
    p.add_argument("--chunk-ms", type=int, default=2240)
    p.add_argument("--latin", action="store_true",
                   help="use the latin-vocab pack instead of full multilingual")
    p.add_argument("--dataset", default="fleurs",
                   choices=["fleurs", "librispeech", "earnings22"])
    p.add_argument("--prompt-override", default=None,
                   help="bypass the FLEURS->prompt mapping (e.g. pt-PT A/B)")
    p.add_argument("--forced-prefix", action="store_true",
                   help="seed decoder with the <xx-XX> tag (hard language lock)")
    p.add_argument("--dump-samples", default=None,
                   help="per-sample JSONL dump path (normalizer debugging)")
    p.add_argument("--output", default=None, help="summary JSON path")
    p.set_defaults(fn=cmd_nemotron_multilingual_fleurs)

    p = sub.add_parser(
        "nemotron-multilingual-multi-stream-bench",
        help="N concurrent multilingual Nemotron streams throughput",
    )
    common(p)
    p.add_argument("--chunk-ms", type=int, default=2240)
    p.add_argument("--latin", action="store_true")
    p.add_argument("--language", default="auto")
    p.add_argument("--repeat", type=int, default=1)
    p.set_defaults(fn=cmd_nemotron_multi_stream_bench)

    p = sub.add_parser("unified-benchmark", help="unified checkpoint WER benchmark")
    common(p, dataset=True)
    p.set_defaults(fn=cmd_unified_benchmark)

    p = sub.add_parser("ja-benchmark", help="Japanese TDT CER benchmark (JSUT layout)")
    common(p, dataset=True)
    p.add_argument("--allow-random-init", action="store_true")
    p.set_defaults(fn=cmd_ja_benchmark)

    p = sub.add_parser("lseend-benchmark", help="LS-EEND DER vs RTTM references")
    common(p, dataset=True)
    p.add_argument("--step-ms", type=int, default=500)
    p.add_argument("--variant", default="dih3")
    p.add_argument("--collar", type=float, default=0.25)
    p.set_defaults(fn=cmd_lseend_benchmark)

    register_corpus(sub)

    p = sub.add_parser("g2p-benchmark", help="G2P phoneme error rate over a lexicon TSV")
    p.add_argument("lexicon")
    p.add_argument("--language", default="eng-us")
    p.add_argument("--max-files", type=int, default=0)
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_g2p_benchmark)


# ------------------------------------------------------ corpus staging


MINIMAX_REPO = "MiniMaxAI/TTS-Multilingual-Test-Set"
MINIMAX_REVISION = "cb416f0ac3658da0577e97873065e19fe6488917"
MINIMAX_LANGUAGES = [
    "arabic", "cantonese", "chinese", "czech", "dutch", "english",
    "finnish", "french", "german", "greek", "hindi", "indonesian",
    "italian", "japanese", "korean", "polish", "portuguese", "romanian",
    "russian", "spanish", "thai", "turkish", "ukrainian", "vietnamese",
]


def convert_minimax_lines(raw: str) -> list[str]:
    """Strip the `<cloning_audio_filename>|` prefix, keep trimmed phrases
    (reference `MinimaxCorpusCommand.convert`)."""
    out = []
    for line in raw.splitlines():
        line = line.strip()
        if not line:
            continue
        _, sep, text = line.partition("|")
        text = (text if sep else line).strip()
        if text:
            out.append(text)
    return out


def cmd_minimax_corpus(args: argparse.Namespace) -> int:
    """Stage the MiniMax Multilingual TTS Test Set as tts-benchmark corpus
    files (reference `MinimaxCorpusCommand.swift`: per-language .txt with a
    provenance header, CC-BY-SA-4.0)."""
    from fluidaudio_tpu_torch.registry import DownloadUtils

    languages = (args.languages.split(",") if args.languages
                 else MINIMAX_LANGUAGES)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    total = 0
    for lang in languages:
        path = DownloadUtils.fetch_hf_file(
            MINIMAX_REPO, f"text/{lang}.txt", out_dir / "_raw",
            revision=args.revision, dataset=True,
        )
        phrases = convert_minimax_lines(path.read_text())
        header = [
            f"# MiniMax Multilingual TTS Test Set — {lang}",
            f"# Source:   https://huggingface.co/datasets/{MINIMAX_REPO}",
            f"# Revision: {args.revision}",
            "# License:  CC-BY-SA-4.0 (Creative Commons Attribution-ShareAlike 4.0)",
            f"# Phrases:  {len(phrases)}",
            "",
        ]
        (out_dir / f"{lang}.txt").write_text("\n".join(header + phrases) + "\n")
        print(f"  [{lang}] {len(phrases):3d} phrases")
        total += len(phrases)
    print(json.dumps({"languages": len(languages), "phrases": total,
                      "out_dir": str(out_dir)}))
    return 0


def register_corpus(sub) -> None:
    p = sub.add_parser(
        "minimax-corpus",
        help="stage the MiniMax TTS test corpus for tts-benchmark",
    )
    p.add_argument("--languages", default="", help="comma list (default: all 24)")
    p.add_argument("--revision", default=MINIMAX_REVISION)
    p.add_argument("--out-dir", default="benchmarks/tts/corpus/minimax")
    p.set_defaults(fn=cmd_minimax_corpus)
