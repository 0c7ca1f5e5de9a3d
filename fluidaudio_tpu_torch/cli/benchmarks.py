"""Dataset benchmark commands: ASR WER (LibriSpeech layout) and diarization
DER/JER (RTTM references), the synthetic guardrail and the streaming
latency probes, on the PyTorch port.

Port of `fluidaudio_tpu/cli/benchmarks.py` (reference
`Commands/.../AsrBenchmark.swift`, LibriSpeech test-clean/test-other WER +
RTFx table, and `DiarizationBenchmark.swift`, DER/JER vs RTTM with collar):
the same arguments, defaults and printed JSON keys. Dataset download is
egress-gated, so the commands consume a local directory; the expected
layouts are documented in --help. Every command runs on the CLI's
`--device` (`cli/main.py`).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def _iter_librispeech(dataset_dir: Path):
    """Yield (utt_id, audio_path, reference_text) from a LibriSpeech-style
    tree: any `*.trans.txt` with lines `<utt-id> <TRANSCRIPT>` and
    `<utt-id>.wav` or `<utt-id>.flac` (native decoder) next to it."""
    for trans in sorted(dataset_dir.rglob("*.trans.txt")):
        for line in trans.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            utt_id, _, text = line.partition(" ")
            for ext in (".wav", ".flac"):
                audio = trans.parent / f"{utt_id}{ext}"
                if audio.exists():
                    yield utt_id, audio, text
                    break


def cmd_asr_benchmark(args: argparse.Namespace) -> int:
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.metrics.text_normalizer import normalize_for_scoring
    from fluidaudio_tpu_torch.metrics.wer import WerBreakdown, levenshtein
    from fluidaudio_tpu_torch.models.zoo import AsrModels

    dataset_dir = Path(args.dataset_dir)
    utts = list(_iter_librispeech(dataset_dir))
    if args.max_files:
        utts = utts[: args.max_files]
    if not utts:
        print(f"no utterances found under {dataset_dir} "
              "(expected LibriSpeech layout: *.trans.txt + <utt>.wav/.flac)")
        return 1

    models = AsrModels.load(args.version, allow_random_init=args.allow_random_init,
                             device=args.device)
    manager = AsrManager(models, ASRConfig(parallel_chunk_batch=args.batch))

    agg = WerBreakdown(0, 0, 0, 0, 0)
    total_audio = 0.0
    total_wall = 0.0
    rows = []
    for utt_id, wav, ref in utts:
        t0 = time.perf_counter()
        result = manager.transcribe(wav)
        wall = time.perf_counter() - t0
        ref_n = normalize_for_scoring(ref).split()
        hyp_n = normalize_for_scoring(result.text).split()
        b = levenshtein(ref_n, hyp_n)
        agg = WerBreakdown(
            agg.errors + b.errors,
            agg.substitutions + b.substitutions,
            agg.insertions + b.insertions,
            agg.deletions + b.deletions,
            agg.reference_length + b.reference_length,
        )
        total_audio += result.duration
        total_wall += wall
        rows.append((utt_id, b.rate, result.duration / max(wall, 1e-9)))
        if args.verbose:
            print(f"  {utt_id}: wer {b.rate * 100:.2f}%  "
                  f"rtfx {result.duration / max(wall, 1e-9):.1f}x")

    summary = {
        "files": len(rows),
        "wer_pct": round(agg.rate * 100, 3),
        "substitutions": agg.substitutions,
        "deletions": agg.deletions,
        "insertions": agg.insertions,
        "reference_words": agg.reference_length,
        "audio_seconds": round(total_audio, 2),
        "rtfx": round(total_audio / max(total_wall, 1e-9), 1),
        "version": args.version,
    }
    print(json.dumps(summary))
    return 0


def _pair_rttm(dataset_dir: Path):
    """Yield (wav, rttm) pairs by matching basenames under a directory."""
    for rttm in sorted(dataset_dir.rglob("*.rttm")):
        wav = rttm.with_suffix(".wav")
        if wav.exists():
            yield wav, rttm


def cmd_diarization_benchmark(args: argparse.Namespace) -> int:
    from fluidaudio_tpu_torch.diarizer.metrics import compute_der
    from fluidaudio_tpu_torch.metrics.rttm import parse_rttm
    from fluidaudio_tpu_torch.utils.converter import AudioConverter

    if args.audio and args.rttm:
        pairs = [(Path(args.audio), Path(args.rttm))]
    elif args.dataset_dir and getattr(args, "ami_annotations", None):
        # NXT-annotation references (reference AMIParser path): pair every
        # <meeting>.wav in the dataset dir with the annotation corpus.
        pairs = [
            (wav, Path(args.ami_annotations))
            for wav in sorted(Path(args.dataset_dir).rglob("*.wav"))
        ]
    elif args.dataset_dir:
        pairs = list(_pair_rttm(Path(args.dataset_dir)))
    else:
        print("provide --audio + --rttm, or --dataset-dir with <name>.wav/<name>.rttm pairs")
        return 1
    if not pairs:
        print("no (wav, rttm) pairs found")
        return 1

    def load_reference(wav: Path, ref: Path):
        if getattr(args, "ami_annotations", None) and not args.rttm:
            from fluidaudio_tpu_torch.metrics import ami_corpus

            meeting = wav.stem.split(".")[0]
            if args.ami_reference == "word":
                return ami_corpus.load_word_aligned_der_reference(meeting, ref)
            if args.ami_reference == "frame":
                return ami_corpus.load_frame_aligned_der_reference(meeting, ref)
            return ami_corpus.load_official_ground_truth(meeting, ref)
        return parse_rttm(ref)

    if args.mode == "offline":
        from fluidaudio_tpu_torch.diarizer.offline import OfflineDiarizerManager

        manager = OfflineDiarizerManager(device=args.device)
    else:
        from fluidaudio_tpu_torch.diarizer import DiarizerManager

        manager = DiarizerManager(device=args.device)

    conv = AudioConverter()
    ders, jers, rows = [], [], []
    total_audio = 0.0
    total_wall = 0.0
    for wav, rttm in pairs:
        samples = conv.resample_file(wav)
        reference = load_reference(wav, rttm)
        t0 = time.perf_counter()
        result = manager.process(samples)
        wall = time.perf_counter() - t0
        der = compute_der(reference, result.segments, collar=args.collar)
        ders.append(der.der)
        jers.append(der.jer)
        total_audio += samples.size / 16000
        total_wall += wall
        rows.append((wav.name, der))
        if args.verbose:
            print(f"  {wav.name}: DER {der.der * 100:.2f}%  JER {der.jer * 100:.2f}%  "
                  f"(miss {der.miss * 100:.1f}% fa {der.false_alarm * 100:.1f}% "
                  f"conf {der.confusion * 100:.1f}%)")

    summary = {
        "files": len(rows),
        "der_pct": round(sum(ders) / len(ders) * 100, 3),
        "jer_pct": round(sum(jers) / len(jers) * 100, 3),
        "collar": args.collar,
        "mode": args.mode,
        "audio_seconds": round(total_audio, 2),
        "rtfx": round(total_audio / max(total_wall, 1e-9), 1),
    }
    print(json.dumps(summary))
    return 0


def _iter_fleurs(dataset_dir: Path):
    """Yield (lang, utt_id, wav_path, transcript) from a FLEURS-style tree:
    `<dataset_dir>/<lang>/test.tsv` (TAB columns: id, filename, transcript,
    [extras...]) with wavs next to the tsv or under `<lang>/audio/`."""
    for lang_dir in sorted(p for p in dataset_dir.iterdir() if p.is_dir()):
        tsv = lang_dir / "test.tsv"
        if not tsv.exists():
            continue
        for line in tsv.read_text().splitlines():
            cols = line.split("\t")
            if len(cols) < 3:
                continue
            utt_id, fname, text = cols[0], cols[1], cols[2]
            for cand in (lang_dir / fname, lang_dir / "audio" / fname,
                         lang_dir / "audio" / "test" / fname):
                if cand.exists():
                    yield lang_dir.name, utt_id, cand, text
                    break


def cmd_fleurs_benchmark(args: argparse.Namespace) -> int:
    """Multilingual WER with decode-time language filtering (reference
    `FleursBenchmark.swift`): per-language WER + macro average; the FLEURS
    locale (e.g. `ru_ru`) selects the script filter passed to
    `AsrManager.transcribe(language=...)`."""
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.metrics.text_normalizer import normalize_for_scoring
    from fluidaudio_tpu_torch.metrics.wer import WerBreakdown, levenshtein
    from fluidaudio_tpu_torch.models.zoo import AsrModels

    dataset_dir = Path(args.dataset_dir)
    utts = list(_iter_fleurs(dataset_dir))
    if args.languages:
        wanted = set(args.languages.split(","))
        utts = [u for u in utts if u[0] in wanted]
    if args.max_files:
        by_lang: dict[str, int] = {}
        kept = []
        for u in utts:
            if by_lang.get(u[0], 0) < args.max_files:
                kept.append(u)
                by_lang[u[0]] = by_lang.get(u[0], 0) + 1
        utts = kept
    if not utts:
        print(f"no utterances found under {dataset_dir} "
              "(expected <lang>/test.tsv + wavs per FLEURS layout)")
        return 1

    models = AsrModels.load(args.version, allow_random_init=args.allow_random_init,
                             device=args.device)
    manager = AsrManager(models, ASRConfig(parallel_chunk_batch=args.batch))

    per_lang: dict[str, WerBreakdown] = {}
    audio_s: dict[str, float] = {}
    wall_s: dict[str, float] = {}
    for lang, utt_id, wav, ref in utts:
        iso = lang.split("_")[0].split("-")[0]  # ru_ru -> ru
        t0 = time.perf_counter()
        result = manager.transcribe(
            wav, language=None if args.no_filter else iso
        )
        wall = time.perf_counter() - t0
        b = levenshtein(
            normalize_for_scoring(ref).split(),
            normalize_for_scoring(result.text).split(),
        )
        prev = per_lang.get(lang, WerBreakdown(0, 0, 0, 0, 0))
        per_lang[lang] = WerBreakdown(
            prev.errors + b.errors,
            prev.substitutions + b.substitutions,
            prev.insertions + b.insertions,
            prev.deletions + b.deletions,
            prev.reference_length + b.reference_length,
        )
        audio_s[lang] = audio_s.get(lang, 0.0) + result.duration
        wall_s[lang] = wall_s.get(lang, 0.0) + wall
        if args.verbose:
            print(f"  [{lang}] {utt_id}: wer {b.rate * 100:.2f}%")

    langs = {
        lang: {
            "wer_pct": round(agg.rate * 100, 3),
            "rtfx": round(audio_s[lang] / max(wall_s[lang], 1e-9), 1),
            "reference_words": agg.reference_length,
        }
        for lang, agg in per_lang.items()
    }
    summary = {
        "languages": langs,
        "macro_wer_pct": round(
            sum(v["wer_pct"] for v in langs.values()) / len(langs), 3
        ),
        "rtfx": round(sum(audio_s.values()) / max(sum(wall_s.values()), 1e-9), 1),
        "version": args.version,
        "language_filter": not args.no_filter,
    }
    print(json.dumps(summary))
    return 0


def cmd_vad_benchmark(args: argparse.Namespace) -> int:
    """VAD accuracy/F1 over a labeled directory (reference VadBenchmark):
    either labels.json {id: {"label": "speech"|"nonspeech"}} next to wavs, or
    a musan-style tree ({speech,music,noise}/ category folders)."""
    import numpy as np

    from fluidaudio_tpu_torch.utils.converter import AudioConverter
    from fluidaudio_tpu_torch.vad import VadManager

    root = Path(args.dataset_dir)
    items: list[tuple[Path, bool]] = []
    labels_file = root / "labels.json"
    if labels_file.exists():
        labels = json.loads(labels_file.read_text())
        for fid, meta in labels.items():
            wav = root / f"{fid}.wav"
            if wav.exists():
                lab = str(meta.get("label", meta.get("category", ""))).lower()
                items.append((wav, lab.startswith("speech")))
    else:
        for cat in ("speech", "music", "noise"):
            for wav in sorted((root / cat).glob("*.wav")):
                items.append((wav, cat == "speech"))
    if args.max_files:
        items = items[: args.max_files]
    if not items:
        print(f"no labeled wavs under {root} (labels.json or musan layout)")
        return 1

    manager = VadManager(device=args.device)
    conv = AudioConverter()
    tp = fp = tn = fn = 0
    total_audio = total_wall = 0.0
    # batch files into shared dispatches (the throughput path; per-file
    # results are identical to solo `process` — pinned in tests/test_vad.py)
    BATCH = 8
    all_results: list = []
    wavs = [conv.resample_file(w) for w, _ in items]
    for i in range(0, len(wavs), BATCH):
        group = wavs[i : i + BATCH]
        t0 = time.perf_counter()
        all_results.extend(manager.process_batch(group))
        total_wall += time.perf_counter() - t0
        total_audio += sum(s.size for s in group) / 16000
    for (wav, is_speech), samples, results in zip(items, wavs, all_results):
        probs = [r.probability for r in results]
        # clips shorter than one VAD window yield no chunk results: score as
        # non-speech explicitly instead of np.mean([]) = NaN (always False)
        pred = bool(probs) and float(
            np.mean([p > args.threshold for p in probs])) > 0.25
        if pred and is_speech:
            tp += 1
        elif pred:
            fp += 1
        elif is_speech:
            fn += 1
        else:
            tn += 1
        if args.verbose:
            print(f"  {wav.name}: speech={is_speech} pred={pred}")
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    summary = {
        "files": len(items),
        "accuracy_pct": round((tp + tn) / len(items) * 100, 2),
        "f1_pct": round(200 * precision * recall / max(precision + recall, 1e-9), 2),
        "rtfx": round(total_audio / max(total_wall, 1e-9), 1),
        "threshold": args.threshold,
    }
    print(json.dumps(summary))
    return 0


def cmd_tts_benchmark(args: argparse.Namespace) -> int:
    """TTS RTFx (+ optional ASR round-trip WER) over a sentence list
    (reference TtsBenchmark.swift)."""
    from fluidaudio_tpu_torch.tts import KokoroManager

    sentences = (
        Path(args.sentences).read_text().splitlines()
        if args.sentences
        else ["The quick brown fox jumps over the lazy dog."] * args.n
    )
    sentences = [s for s in sentences if s.strip()][: args.n]
    manager = KokoroManager(device=args.device)
    total_audio = total_wall = 0.0
    wers = []
    for text in sentences:
        t0 = time.perf_counter()
        r = manager.synthesize(text, voice=args.voice)
        total_wall += time.perf_counter() - t0
        total_audio += r.duration
        if args.roundtrip:
            # score the audio already synthesized above (tts_asr_roundtrip
            # would synthesize a second time, doubling the dominant cost)
            from fluidaudio_tpu_torch.asr.config import ASRConfig
            from fluidaudio_tpu_torch.asr.manager import AsrManager
            from fluidaudio_tpu_torch.metrics.text_normalizer import normalize_for_scoring
            from fluidaudio_tpu_torch.metrics.wer import wer
            from fluidaudio_tpu_torch.models.zoo import AsrModels
            from fluidaudio_tpu_torch.utils.converter import resample

            if not hasattr(manager, "_rt_asr"):
                manager._rt_asr = AsrManager(
                    AsrModels.load("v3", allow_random_init=True, device=args.device),
                    ASRConfig())
            import numpy as np
            audio16k = resample(
                np.asarray(r.samples, np.float32), r.sample_rate, 16_000)
            hyp = manager._rt_asr.transcribe(audio16k).text
            wers.append(
                wer(normalize_for_scoring(text), normalize_for_scoring(hyp)).rate)
    summary = {
        "sentences": len(sentences),
        "audio_seconds": round(total_audio, 2),
        "rtfx": round(total_audio / max(total_wall, 1e-9), 2),
        "voice": args.voice,
    }
    if wers:
        summary["roundtrip_wer_pct"] = round(sum(wers) / len(wers) * 100, 2)
    print(json.dumps(summary))
    return 0


def cmd_sortformer_benchmark(args: argparse.Namespace) -> int:
    """Sortformer DER vs RTTM references (reference SortformerBenchmark)."""
    from fluidaudio_tpu_torch.diarizer.metrics import compute_der
    from fluidaudio_tpu_torch.diarizer.sortformer import SortformerDiarizer
    from fluidaudio_tpu_torch.metrics.rttm import parse_rttm
    from fluidaudio_tpu_torch.utils.converter import AudioConverter

    pairs = list(_pair_rttm(Path(args.dataset_dir)))
    if not pairs:
        print("no (wav, rttm) pairs found")
        return 1
    manager = SortformerDiarizer(device=args.device)
    conv = AudioConverter()
    ders, total_audio, total_wall = [], 0.0, 0.0
    for wav, rttm in pairs:
        samples = conv.resample_file(wav)
        reference = parse_rttm(rttm)
        t0 = time.perf_counter()
        result = (manager.process_offline(samples) if args.mode == "offline"
                  else manager.process(samples))
        total_wall += time.perf_counter() - t0
        total_audio += samples.size / 16000
        der = compute_der(reference, result.segments, collar=args.collar)
        ders.append(der.der)
        if args.verbose:
            print(f"  {wav.name}: DER {der.der * 100:.2f}%")
    summary = {
        "files": len(pairs),
        "der_pct": round(sum(ders) / len(ders) * 100, 3),
        "mode": args.mode,
        "rtfx": round(total_audio / max(total_wall, 1e-9), 1),
    }
    print(json.dumps(summary))
    return 0


def cmd_ctc_earnings_benchmark(args: argparse.Namespace) -> int:
    """Earnings22 keyword-spotting: WER + keyword recall/F1 (reference
    CtcEarningsBenchmark). Layout: <id>.wav + <id>.txt + labels.json with
    per-file {"keywords": [...]} lists."""
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.custom_vocab import CustomVocabularyContext, VocabularyTerm
    from fluidaudio_tpu_torch.asr.keyword_spotter import CtcKeywordSpotter, KeywordSpotterConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.metrics.text_normalizer import normalize_for_scoring
    from fluidaudio_tpu_torch.metrics.wer import WerBreakdown, levenshtein
    from fluidaudio_tpu_torch.models.zoo import AsrModels
    from fluidaudio_tpu_torch.utils.converter import AudioConverter

    root = Path(args.dataset_dir)
    labels = json.loads((root / "labels.json").read_text()) \
        if (root / "labels.json").exists() else {}
    items = []
    for wav in sorted(root.glob("*.wav")):
        txt = wav.with_suffix(".txt")
        if txt.exists():
            kws = labels.get(wav.stem, {}).get("keywords", [])
            items.append((wav, txt.read_text().strip(), [k.lower() for k in kws]))
    if args.max_files:
        items = items[: args.max_files]
    if not items:
        print(f"no <id>.wav + <id>.txt pairs under {root}")
        return 1

    models = AsrModels.load(args.version, allow_random_init=args.allow_random_init,
                             device=args.device)
    manager = AsrManager(models, ASRConfig())
    conv = AudioConverter()
    agg = WerBreakdown(0, 0, 0, 0, 0)
    kw_tp = kw_fn = kw_fp = 0
    total_audio = total_wall = 0.0
    for wav, ref, keywords in items:
        samples = conv.resample_file(wav)
        t0 = time.perf_counter()
        result = manager.transcribe(samples)
        spots = []
        if keywords:
            ctx = CustomVocabularyContext(
                [VocabularyTerm(k) for k in keywords],
                tokenizer=models.tokenizer)
            spotter = CtcKeywordSpotter(
                ctx, KeywordSpotterConfig(vocab_size=models.blank_id), device=args.device)
            spots = spotter.spot(samples)
        total_wall += time.perf_counter() - t0
        total_audio += samples.size / 16000
        b = levenshtein(normalize_for_scoring(ref).split(),
                        normalize_for_scoring(result.text).split())
        agg = WerBreakdown(
            agg.errors + b.errors, agg.substitutions + b.substitutions,
            agg.insertions + b.insertions, agg.deletions + b.deletions,
            agg.reference_length + b.reference_length)
        found = {s.keyword.lower() for s in spots}
        ref_words = set(normalize_for_scoring(ref).split())
        for kw in keywords:
            present = kw in ref_words or kw in normalize_for_scoring(ref)
            if present and kw in found:
                kw_tp += 1
            elif present:
                kw_fn += 1
            elif kw in found:
                kw_fp += 1
    recall = kw_tp / max(kw_tp + kw_fn, 1)
    precision = kw_tp / max(kw_tp + kw_fp, 1)
    summary = {
        "files": len(items),
        "wer_pct": round(agg.rate * 100, 3),
        "keyword_recall_pct": round(recall * 100, 2),
        "keyword_f1_pct": round(
            200 * precision * recall / max(precision + recall, 1e-9), 2),
        "rtfx": round(total_audio / max(total_wall, 1e-9), 1),
    }
    print(json.dumps(summary))
    return 0


def cmd_download_dataset(args: argparse.Namespace) -> int:
    """Stage a benchmark dataset into the cache (egress-gated)."""
    from fluidaudio_tpu_torch.registry.datasets import DatasetDownloader

    dl = DatasetDownloader(root=args.output_dir)
    name = args.dataset
    try:
        if name == "ami-sdm":
            out = dl.download_ami("sdm")
        elif name == "ami-ihm":
            out = dl.download_ami("ihm")
        elif name.startswith("musan"):
            out = dl.download_musan(name.split("-", 1)[1] if "-" in name else "mini50")
        elif name == "earnings22-kws":
            out = dl.download_earnings22_kws(max_files=args.max_files or 10)
        elif name == "voices":
            out = dl.download_voices_subset(max_files=args.max_files or 50)
        elif name.startswith("librispeech"):
            subset = name.split("-", 1)[1] if "-" in name else "test-clean"
            out = dl.download_librispeech(subset)
        elif name == "fleurs":
            out = dl.download_fleurs(getattr(args, "languages", "") or
                                     "es_419,fr_fr,de_de")
        elif name in ("jsut", "jsut-basic5000"):
            out = dl.download_jsut(max_files=args.max_files)
        else:
            print(f"unknown dataset {name!r}")
            return 1
    except Exception as e:  # OfflineError surfaces cleanly
        print(f"download failed: {e}")
        return 1
    print(json.dumps({"dataset": name, "path": str(out)}))
    return 0


def cmd_synthetic_guardrail(args: argparse.Namespace) -> int:
    """Egress-free end-to-end guardrail battery, two tiers:

    REAL QUALITY GATES (committed trained tiny fixtures, the reference's
    benchmark-guardrail CI analog — offline-pipeline.yml, README.md:654):
      trained_asr_wer_pct   full chunked AsrManager.transcribe on the trained
                            16-word language — HARD GATE <= 2%
      trained_vad_f1_pct    trained Silero clip F1 — HARD GATE >= 90%
      trained_diar_der_pct  trained sortformer offline DER — HARD GATE <= 5%
      trained_{sensevoice,paraformer,cohere,eou}_wer_pct — per-architecture
                            families, gated <= 2% when their fixture exists
      trained_eou_detect_pct  EOU flag must fire per utterance (>= 99%)
      trained_lseend_der_pct  online attractor diarizer — HARD GATE <= 10%
      trained_offline_der_pct offline seg->emb->PLDA->AHC->VBx — GATE <= 5%
      trained_nemotron_{wer,detect}_pct  multilingual prompts + auto-detect
      trained_ctc_wer_pct / trained_kws_{recall,precision}_pct  CTC decode +
                            DP keyword spotting (Earnings22-KWS path)
      trained_tts_roundtrip_wer_pct  Kokoro synth -> resample -> trained ASR
                            (the tts-asr-verify contract) — GATE <= 2%
    A gate failure exits nonzero regardless of --baseline: the framework must
    demonstrably transcribe / detect speech / diarize.

    DETERMINISM PINS (seeded random weights + seeded audio; numerically
    tracked noise, NOT quality — catches silent numeric drift per backend):
      asr_batch_invariant / asr_tokens / asr_stream_sha   chunk batch 1 vs 3
      roundtrip_pin_wer_pct   Kokoro TTS -> ASR round trip (random weights)
      vad_prob_sha            synthetic corpus probability checksum

    With --baseline, numeric fields compare within tolerances and string
    fields exactly; nonzero exit on drift.
    """
    import hashlib

    import numpy as np
    import torch

    dev = args.device
    out: dict[str, object] = {"backend": dev.type, "torch": torch.__version__}
    rng = np.random.RandomState(0)

    # --- family selection (fast verification tier): `--families asr,vad`
    # runs only those gate sections so a regression is provable inside a
    # 10-minute window on a 1-core host; "pins" selects the seeded-random
    # drift-pin battery. Default = everything.
    all_families = ("asr", "vad", "sortformer", "sensevoice", "paraformer",
                    "cohere", "eou", "lseend", "nemotron", "ctc", "tts",
                    "pocket", "styletts2", "offline", "online", "pins")
    if getattr(args, "families", None):
        want = {f.strip() for f in args.families.split(",") if f.strip()}
        unknown = want - set(all_families)
        if unknown:
            print(f"unknown families: {sorted(unknown)}; "
                  f"choose from {all_families}")
            return 2
        out["families"] = sorted(want)
    else:
        want = set(all_families)

    # --- tier 1: REAL quality gates on the committed trained fixtures ------
    from fluidaudio_tpu_torch.train import fixtures as fx

    gate_failures: list[str] = []
    if not fx.fixtures_available():
        out["trained_fixtures"] = "absent"
    if "asr" in want and fx.fixtures_available("asr"):
        asr_scores = fx.eval_asr_fixture(n_words=(5, 40), device=dev)
        out["trained_asr_wer_pct"] = round(asr_scores["wer_avg"] * 100, 2)
        if asr_scores["wer_avg"] > fx.ASR_WER_GATE:
            gate_failures.append(
                f"trained ASR WER {out['trained_asr_wer_pct']}% > "
                f"{fx.ASR_WER_GATE * 100}%")
    if "vad" in want and fx.fixtures_available("vad"):
        vad_f1 = fx.eval_vad_fixture(device=dev)
        out["trained_vad_f1_pct"] = round(vad_f1 * 100, 1)
        if vad_f1 < fx.VAD_F1_GATE:
            gate_failures.append(
                f"trained VAD F1 {out['trained_vad_f1_pct']}% < "
                f"{fx.VAD_F1_GATE * 100}%")
    if "sortformer" in want and fx.fixtures_available("sortformer"):
        der = fx.eval_sortformer_fixture(device=dev)
        out["trained_diar_der_pct"] = round(der * 100, 2)
        if der > fx.DIAR_DER_GATE:
            gate_failures.append(
                f"trained diarizer DER {out['trained_diar_der_pct']}% > "
                f"{fx.DIAR_DER_GATE * 100}%")

    # per-architecture ASR families (SANM+CTC / CIF / attention enc-dec):
    # gated only when their fixtures are committed
    for fam, evaluator in (
        ("sensevoice", fx.eval_sensevoice_fixture),
        ("paraformer", fx.eval_paraformer_fixture),
        ("cohere", fx.eval_cohere_fixture),
    ):
        if fam not in want or not fx.fixtures_available(fam):
            continue
        w = evaluator(n_utts=3, device=dev)
        out[f"trained_{fam}_wer_pct"] = round(w * 100, 2)
        if w > fx.ASR_WER_GATE:
            gate_failures.append(
                f"trained {fam} WER {out[f'trained_{fam}_wer_pct']}% > "
                f"{fx.ASR_WER_GATE * 100}%")

    # streaming EOU family: WER through the chunked cache-carrying path AND
    # the end-of-utterance flag itself
    if "eou" in want and fx.fixtures_available("eou"):
        eou_scores = fx.eval_eou_fixture(n_utts=3, device=dev)
        out["trained_eou_wer_pct"] = round(eou_scores["wer_avg"] * 100, 2)
        out["trained_eou_detect_pct"] = round(
            eou_scores["eou_detect_rate"] * 100, 1)
        if eou_scores["wer_avg"] > fx.ASR_WER_GATE:
            gate_failures.append(
                f"trained eou WER {out['trained_eou_wer_pct']}% > "
                f"{fx.ASR_WER_GATE * 100}%")
        if eou_scores["eou_detect_rate"] < 0.99:
            gate_failures.append(
                f"trained eou detect {out['trained_eou_detect_pct']}% < 99%")

    # online LS-EEND diarizer
    if "lseend" in want and fx.fixtures_available("lseend"):
        lseend_der = fx.eval_lseend_fixture(seconds=30.0, device=dev)
        out["trained_lseend_der_pct"] = round(lseend_der * 100, 2)
        if lseend_der > fx.LSEEND_DER_GATE:
            gate_failures.append(
                f"trained lseend DER {out['trained_lseend_der_pct']}% > "
                f"{fx.LSEEND_DER_GATE * 100}%")

    # multilingual streaming Nemotron: prompt conditioning + auto-detect
    if "nemotron" in want and fx.fixtures_available("nemotron"):
        nem = fx.eval_nemotron_fixture(n_utts=4, device=dev)
        out["trained_nemotron_wer_pct"] = round(nem["wer_avg"] * 100, 2)
        out["trained_nemotron_detect_pct"] = round(
            nem["lang_detect_rate"] * 100, 1)
        if nem["wer_avg"] > fx.ASR_WER_GATE:
            gate_failures.append(
                f"trained nemotron WER {out['trained_nemotron_wer_pct']}% > "
                f"{fx.ASR_WER_GATE * 100}%")
        if nem["lang_detect_rate"] < 0.99:
            gate_failures.append(
                f"trained nemotron lang detect "
                f"{out['trained_nemotron_detect_pct']}% < 99%")

    # CTC decode + keyword spotting (Earnings22-KWS path)
    if "ctc" in want and fx.fixtures_available("ctc"):
        ctc = fx.eval_ctc_fixture(device=dev)
        kws = fx.eval_ctc_spotting_fixture(device=dev)
        out["trained_ctc_wer_pct"] = round(ctc["wer_avg"] * 100, 2)
        out["trained_kws_recall_pct"] = round(kws["recall"] * 100, 1)
        out["trained_kws_precision_pct"] = round(kws["precision"] * 100, 1)
        if ctc["wer_avg"] > fx.ASR_WER_GATE:
            gate_failures.append(
                f"trained ctc WER {out['trained_ctc_wer_pct']}% > "
                f"{fx.ASR_WER_GATE * 100}%")
        if kws["recall"] < fx.KWS_RECALL_GATE:
            gate_failures.append(
                f"trained KWS recall {out['trained_kws_recall_pct']}% < "
                f"{fx.KWS_RECALL_GATE * 100}%")
        if kws["precision"] < fx.KWS_PRECISION_GATE:
            gate_failures.append(
                f"trained KWS precision {out['trained_kws_precision_pct']}% < "
                f"{fx.KWS_PRECISION_GATE * 100}%")
        # end-to-end vocabulary-boost WER-improvement claim
        boost = fx.eval_vocab_boost_fixture(device=dev)
        out["trained_boost_wer_before_pct"] = round(
            boost["wer_before"] * 100, 2)
        out["trained_boost_wer_after_pct"] = round(boost["wer_after"] * 100, 2)
        if not (boost["wer_before"] > 0 and boost["wer_after"] == 0.0
                and boost["corrected"] == 1.0 and boost["false_boost"] == 0.0):
            gate_failures.append(f"vocab boost gate failed: {boost}")

    # TTS: trained Kokoro fixture, closed-loop verified by the trained ASR
    # fixture (the reference tts-asr-verify contract)
    if "tts" in want and fx.fixtures_available("tts", "asr"):
        tts = fx.eval_tts_fixture(device=dev)
        out["trained_tts_roundtrip_wer_pct"] = round(
            tts["roundtrip_wer_avg"] * 100, 2)
        out["trained_tts_dur_mae_frames"] = round(tts["dur_mae_frames"], 3)
        if tts["roundtrip_wer_avg"] > fx.TTS_ROUNDTRIP_WER_GATE:
            gate_failures.append(
                f"trained TTS roundtrip WER "
                f"{out['trained_tts_roundtrip_wer_pct']}% > "
                f"{fx.TTS_ROUNDTRIP_WER_GATE * 100}%")
        if tts["dur_mae_frames"] >= 0.5:
            gate_failures.append(
                f"trained TTS duration MAE {out['trained_tts_dur_mae_frames']}"
                f" frames >= 0.5 (rounding-unsafe)")

    # PocketTTS: trained streaming-AR fixture (flow-LM prefill + EOS +
    # 8-step Euler flow + streaming Mimi decode), closed-loop verified by
    # the trained ASR fixture; also gates the clone_voice path
    if "pocket" in want and fx.fixtures_available("pocket", "asr"):
        pk = fx.eval_pocket_fixture(device=dev)
        out["trained_pocket_roundtrip_wer_pct"] = round(
            pk["roundtrip_wer_avg"] * 100, 2)
        out["trained_pocket_clone_wer_pct"] = round(
            pk["clone_roundtrip_wer"] * 100, 2)
        if pk["roundtrip_wer_avg"] > fx.POCKET_ROUNDTRIP_WER_GATE:
            gate_failures.append(
                f"trained PocketTTS roundtrip WER "
                f"{out['trained_pocket_roundtrip_wer_pct']}% > "
                f"{fx.POCKET_ROUNDTRIP_WER_GATE * 100}%")
        if pk["clone_roundtrip_wer"] > fx.POCKET_ROUNDTRIP_WER_GATE:
            gate_failures.append(
                f"trained PocketTTS clone-voice WER "
                f"{out['trained_pocket_clone_wer_pct']}% > "
                f"{fx.POCKET_ROUNDTRIP_WER_GATE * 100}%")

    # StyleTTS2: trained diffusion-TTS fixture (EDM/ADPM2 style sampling +
    # AdaIN HiFi-GAN), closed-loop verified by the trained ASR fixture
    if "styletts2" in want and fx.fixtures_available("styletts2", "asr"):
        st = fx.eval_styletts2_fixture(device=dev)
        out["trained_styletts2_roundtrip_wer_pct"] = round(
            st["roundtrip_wer_avg"] * 100, 2)
        out["trained_styletts2_dur_mae_frames"] = round(
            st["dur_mae_frames"], 3)
        if st["roundtrip_wer_avg"] > fx.STYLETTS2_ROUNDTRIP_WER_GATE:
            gate_failures.append(
                f"trained StyleTTS2 roundtrip WER "
                f"{out['trained_styletts2_roundtrip_wer_pct']}% > "
                f"{fx.STYLETTS2_ROUNDTRIP_WER_GATE * 100}%")
        if st["dur_mae_frames"] >= 0.5:
            gate_failures.append(
                f"trained StyleTTS2 duration MAE "
                f"{out['trained_styletts2_dur_mae_frames']}"
                f" frames >= 0.5 (rounding-unsafe)")

    # offline multi-stage pipeline (seg -> emb -> PLDA -> AHC -> VBx)
    if "offline" in want and fx.fixtures_available("offline"):
        off_der = fx.eval_offline_diarizer_fixture(seconds=30.0, device=dev)
        out["trained_offline_der_pct"] = round(off_der * 100, 2)
        if off_der > fx.DIAR_DER_GATE:
            gate_failures.append(
                f"trained offline DER {out['trained_offline_der_pct']}% > "
                f"{fx.DIAR_DER_GATE * 100}%")

    # online streaming pyannote diarizer (reuses the offline checkpoints,
    # like the reference's model sharing between DiarizerManager and
    # OfflineDiarizerManager)
    if "online" in want and fx.fixtures_available("offline"):
        online = fx.eval_online_diarizer_fixture(seconds=30.0, device=dev)
        out["trained_online_der_pct"] = round(online["der"] * 100, 2)
        out["trained_online_speakers"] = online["speaker_count"]
        if online["der"] > fx.ONLINE_DIAR_DER_GATE:
            gate_failures.append(
                f"trained online-diarizer DER {out['trained_online_der_pct']}%"
                f" > {fx.ONLINE_DIAR_DER_GATE * 100}%")
        if online["speaker_count"] != 2:
            gate_failures.append(
                f"trained online-diarizer speakers "
                f"{online['speaker_count']} != 2")

    # --- tier 2: seeded-random drift pins (selectable as 'pins') ---------
    if "pins" in want:
        def speechish(seconds: float, seed: int) -> np.ndarray:
            r = np.random.RandomState(seed)
            t = np.arange(int(seconds * 16000)) / 16000.0
            env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t)) * (
                0.3 + 0.7 * (np.sin(2 * np.pi * 0.31 * t) > 0)
            )
            return (r.randn(t.size) * 0.1 * (0.05 + env)).astype(np.float32)

        # --- asr: merge determinism + token-stream checksum --------------------
        from fluidaudio_tpu_torch.asr.config import ASRConfig
        from fluidaudio_tpu_torch.asr.manager import AsrManager
        from fluidaudio_tpu_torch.models.zoo import AsrModels

        # plain gaussian, not speech-shaped: seeded-random weights happen to stay
        # blank-dominated on AM-modulated noise, and a 0-token stream would make
        # the determinism check vacuous
        audio = (np.random.RandomState(7).randn(700_000) * 0.1).astype(np.float32)
        streams = []
        for bs in (1, 3):
            m = AsrManager(
                AsrModels.load(args.version, allow_random_init=True, device=dev),
                ASRConfig(parallel_chunk_batch=bs),
            )
            r = m.transcribe(audio)
            streams.append([(t.token_id, round(t.start_time, 3)) for t in r.token_timings])
        out["asr_batch_invariant"] = streams[0] == streams[1]
        out["asr_tokens"] = len(streams[0])
        out["asr_stream_sha"] = hashlib.sha1(
            json.dumps(streams[0]).encode()
        ).hexdigest()[:16]

        # --- tts -> asr roundtrip ---------------------------------------------
        from fluidaudio_tpu_torch.metrics.text_normalizer import normalize_for_scoring
        from fluidaudio_tpu_torch.metrics.wer import wer
        from fluidaudio_tpu_torch.tts import KokoroManager
        from fluidaudio_tpu_torch.utils.converter import resample

        sentences = [
            "the quick brown fox jumps over the lazy dog",
            "speech synthesis round trips through recognition",
            "numbers like twenty five stay stable across rounds",
        ][: args.sentences]
        tts = KokoroManager(device=dev)
        asr = AsrManager(
            AsrModels.load(args.version, allow_random_init=True, device=dev), ASRConfig()
        )
        wers = []
        for s in sentences:
            audio_tts = tts.synthesize(s)
            a16 = resample(np.asarray(audio_tts.samples, np.float32),
                           audio_tts.sample_rate, 16000)
            hyp = asr.transcribe(a16).text
            wers.append(wer(normalize_for_scoring(s), normalize_for_scoring(hyp)).rate)
        # random-weight drift pin, NOT quality (the trained gate above is quality)
        out["roundtrip_pin_wer_pct"] = round(100 * sum(wers) / len(wers), 2)

        # --- vad probability checksum (drift pin) -------------------------------
        from fluidaudio_tpu_torch.vad import VadManager

        vad = VadManager(device=dev)
        utts = [speechish(2.0, seed=100 + i) for i in range(4)] + [
            (np.random.RandomState(200 + i).randn(32000) * 0.002).astype(np.float32)
            for i in range(4)
        ]
        batches = vad.process_batch(utts)
        probs = [float(np.mean([r.probability for r in b])) for b in batches]
        out["vad_prob_sha"] = hashlib.sha1(
            json.dumps([round(p, 5) for p in probs]).encode()
        ).hexdigest()[:16]

    print(json.dumps(out))

    if gate_failures:
        print("guardrail QUALITY GATE FAILED: " + "; ".join(gate_failures))
        return 1

    if args.baseline:
        base = json.loads(Path(args.baseline).read_text())
        if base.get("backend") != out["backend"]:
            print(f"guardrail: baseline backend {base.get('backend')} != "
                  f"{out['backend']}; skipping comparison")
            return 0
        if base.get("torch") != out["torch"]:
            # float checksums are only bit-stable on the same stack: compare
            # the tolerance-gated numbers, drop the exact-match sha fields
            print(f"guardrail: baseline torch {base.get('torch')} != {out['torch']};"
                  " comparing tolerance-gated fields only")
            base = {k: v for k, v in base.items() if not k.endswith("_sha")}
        tol = {"roundtrip_pin_wer_pct": 5.0, "asr_tokens": 0,
               # trained-fixture numbers must hold their gates, but small
               # cross-toolchain float drift inside the gate is fine
               "trained_asr_wer_pct": 2.0, "trained_vad_f1_pct": 5.0,
               "trained_diar_der_pct": 3.0, "trained_sensevoice_wer_pct": 2.0,
               "trained_paraformer_wer_pct": 2.0, "trained_cohere_wer_pct": 2.0}
        failures = []
        for key, ref in base.items():
            if key == "families" or (key not in out and want != set(all_families)):
                # family-selected run: compare only the sections that ran
                continue
            got = out.get(key)
            if isinstance(ref, (int, float)) and not isinstance(ref, bool):
                if abs(float(got) - float(ref)) > tol.get(key, 0.0):
                    failures.append(f"{key}: {got} vs baseline {ref}")
            elif got != ref:
                failures.append(f"{key}: {got!r} vs baseline {ref!r}")
        if failures:
            print("guardrail DRIFT: " + "; ".join(failures))
            return 1
        print("guardrail: within baseline tolerances")
    return 0


def register(sub: argparse._SubParsersAction) -> None:
    p = sub.add_parser(
        "synthetic-guardrail",
        help="egress-free deterministic end-to-end battery (seeded weights); "
             "catches relative regressions without real checkpoints",
    )
    p.add_argument("--version", default="v3", help="ASR zoo version (test-tiny for CI)")
    p.add_argument("--sentences", type=int, default=3)
    p.add_argument("--baseline", help="baseline JSON to compare against")
    p.add_argument(
        "--families",
        help="comma-separated gate selection (asr,vad,sortformer,sensevoice,"
             "paraformer,cohere,eou,lseend,nemotron,ctc,tts,offline,pins); "
             "default all. Use for a fast per-family verification tier.",
    )
    p.set_defaults(fn=cmd_synthetic_guardrail)

    p = sub.add_parser(
        "vad-benchmark",
        help="VAD accuracy/F1 over labeled wavs (musan layout or labels.json)",
    )
    p.add_argument("--dataset-dir", required=True)
    p.add_argument("--threshold", type=float, default=0.85)
    p.add_argument("--max-files", type=int, default=0)
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_vad_benchmark)

    p = sub.add_parser("tts-benchmark", help="TTS RTFx (+ round-trip WER)")
    p.add_argument("--sentences", help="text file, one sentence per line")
    p.add_argument("-n", type=int, default=4)
    p.add_argument("--voice", default="af_heart")
    p.add_argument("--roundtrip", action="store_true")
    p.set_defaults(fn=cmd_tts_benchmark)

    p = sub.add_parser(
        "sortformer-benchmark", help="Sortformer DER vs RTTM references"
    )
    p.add_argument("--dataset-dir", required=True)
    p.add_argument("--mode", choices=["streaming", "offline"], default="streaming")
    p.add_argument("--collar", type=float, default=0.25)
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_sortformer_benchmark)

    p = sub.add_parser(
        "ctc-earnings-benchmark",
        help="Earnings22 WER + keyword recall/F1 (CTC-WS boosting)",
    )
    p.add_argument("--dataset-dir", required=True)
    p.add_argument("--version", default="v3")
    p.add_argument("--max-files", type=int, default=0)
    p.add_argument("--allow-random-init", action="store_true")
    p.set_defaults(fn=cmd_ctc_earnings_benchmark)

    p = sub.add_parser(
        "download-dataset",
        help="stage a benchmark dataset (ami-sdm/ami-ihm/musan-*/earnings22-kws/"
             "voices/librispeech-test-clean/fleurs/jsut-basic5000)",
    )
    p.add_argument("dataset")
    p.add_argument("--output-dir")
    p.add_argument("--max-files", type=int, default=0)
    p.add_argument("--languages", default="", help="fleurs: comma locale list")
    p.set_defaults(fn=cmd_download_dataset)

    p = sub.add_parser(
        "fleurs-benchmark",
        help="multilingual WER (FLEURS layout) with decode-time script filter",
    )
    p.add_argument("--dataset-dir", required=True,
                   help="dir with <lang>/test.tsv + wavs (FLEURS layout)")
    p.add_argument("--version", default="v3")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max-files", type=int, default=0, help="per language")
    p.add_argument("--languages", default="", help="comma list, e.g. ru_ru,pl_pl")
    p.add_argument("--no-filter", action="store_true",
                   help="disable decode-time language filtering")
    p.add_argument("--allow-random-init", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_fleurs_benchmark)

    p = sub.add_parser(
        "asr-benchmark",
        help="WER benchmark over a local LibriSpeech-layout directory",
    )
    p.add_argument("--dataset-dir", required=True,
                   help="dir with *.trans.txt + <utt>.wav (LibriSpeech layout)")
    p.add_argument("--version", default="v3")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max-files", type=int, default=0)
    p.add_argument("--allow-random-init", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_asr_benchmark)

    p = sub.add_parser(
        "diarization-benchmark",
        help="DER/JER benchmark vs RTTM references",
    )
    p.add_argument("--audio", help="single wav file")
    p.add_argument("--rttm", help="reference RTTM for --audio")
    p.add_argument("--dataset-dir", help="dir with <name>.wav/<name>.rttm pairs")
    p.add_argument(
        "--ami-annotations",
        help="AMI NXT annotation root (segments/ + corpusResources/meetings.xml); "
        "replaces RTTM pairing with parsed ground truth",
    )
    p.add_argument(
        "--ami-reference",
        choices=["word", "official", "frame"],
        default="word",
        help="NXT reference flavor: word-aligned (default), official segments, "
        "or 10ms frame-quantized",
    )
    p.add_argument("--mode", choices=["online", "offline"], default="offline")
    p.add_argument("--collar", type=float, default=0.25)
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_diarization_benchmark)

    p = sub.add_parser(
        "emission-delay-benchmark",
        help="streaming token emission-delay distribution (EOU pipeline)",
    )
    p.add_argument("--audio", help="wav file (default: synthetic tone bursts)")
    p.add_argument("--chunk-ms", type=int, default=160, choices=[160, 320, 1280])
    p.add_argument("--synthetic-seconds", type=float, default=8.0)
    p.set_defaults(fn=cmd_emission_delay_benchmark)

    p = sub.add_parser(
        "streaming-latency-benchmark",
        help="single-stream per-chunk latency of N carried chunk steps "
             "(CUDA events) + dispatch p50/p95 of process()",
    )
    p.add_argument("--tiers", help="comma-separated chunk tiers (default all)")
    p.add_argument("--chunks", type=int, default=64,
                   help="chunk steps driven per timed run")
    p.add_argument("--iters", type=int, default=3)
    p.set_defaults(fn=cmd_streaming_latency_benchmark)


def cmd_emission_delay_benchmark(args: argparse.Namespace) -> int:
    """Streaming emission-delay benchmark (reference EmissionDelayBenchmark):
    for each token, delay = audio-time available when it was emitted minus the
    token's own audio timestamp; plus per-chunk compute latency."""
    import numpy as np

    from fluidaudio_tpu_torch.asr.streaming_eou import StreamingEouAsrManager

    manager = StreamingEouAsrManager(chunk_ms=args.chunk_ms, device=args.device)
    chunk_ms = args.chunk_ms

    if args.audio:
        from fluidaudio_tpu_torch.utils.converter import AudioConverter

        samples = AudioConverter().resample_file(args.audio)
    else:
        rng = np.random.RandomState(0)
        t = np.arange(int(16000 * args.synthetic_seconds)) / 16000.0
        # modulated tone bursts — produces nonzero mel energy patterns
        samples = (np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 1.5 * t) > 0)
                   * 0.3 + rng.randn(t.size) * 0.01).astype(np.float32)

    state = manager.make_state()
    feed = int(16000 * chunk_ms / 1000)
    delays, chunk_walls = [], []
    fed_ms = 0.0
    seen_tokens = 0
    for off in range(0, samples.size - feed + 1, feed):
        t0 = time.perf_counter()
        results = manager.process(samples[off : off + feed], state)
        chunk_walls.append((time.perf_counter() - t0) * 1000)
        fed_ms += chunk_ms
        for r in results:
            for ts in r.timestamps_ms[seen_tokens:]:
                delays.append(fed_ms - ts)
            seen_tokens = len(r.timestamps_ms)
    final = manager.finish(state)

    summary = {
        "tokens": len(delays),
        "emission_delay_p50_ms": round(float(np.percentile(delays, 50)), 1) if delays else None,
        "emission_delay_p90_ms": round(float(np.percentile(delays, 90)), 1) if delays else None,
        "emission_delay_mean_ms": round(float(np.mean(delays)), 1) if delays else None,
        "chunk_ms": chunk_ms,
        "chunk_compute_mean_ms": round(float(np.mean(chunk_walls)), 2) if chunk_walls else None,
        "audio_seconds": round(samples.size / 16000, 2),
        "final_text_len": len(final.text),
    }
    print(json.dumps(summary))
    return 0


def cmd_streaming_latency_benchmark(args: argparse.Namespace) -> int:
    """Single-stream streaming latency probe of the EOU pipeline.

    JAX rolls N chunk steps into one `lax.scan` program and divides its wall
    time by N. The port drives the same N steps (the manager's `_chunk_step`,
    which `process` runs too: mel -> encoder step -> RNN-T decode, the
    conformer caches, the decoder state and the last sample carried on the
    device across chunks, `time_jump` zeroed) from one host loop, with no copy of any output to the host until the end, and
    times the loop with CUDA events (on the CPU, the host clock), best of
    `--iters`. The steps are not one device program: the RNN-T decode reads
    `any(active)` from the device every `ACTIVE_CHECK_EVERY` decode steps
    (`ops/tdt_decode.py`), so each chunk step waits on the device at least
    once. `tokens_emitted` is the N steps' summed token count, what
    `process` emits over the same chunks. The single-dispatch p50/p95 of
    `process` (host wall per call, as in JAX) is reported beside it.

    Reference comparison: BASELINE.md "ASR — streaming" per-chunk latencies.
    """
    import numpy as np
    import torch

    from fluidaudio_tpu_torch.asr.streaming_eou import (
        CHUNK_TIERS_MS,
        MEL_HOP,
        MEL_WIN,
        StreamingEouAsrManager,
    )

    tiers = [int(t) for t in args.tiers.split(",")] if args.tiers else list(CHUNK_TIERS_MS)
    n = args.chunks
    dev = args.device
    out: dict[str, object] = {"backend": dev.type, "chunks": n}

    for tier in tiers:
        mgr = StreamingEouAsrManager(chunk_ms=tier, device=args.device)
        need = mgr.chunk_samples + MEL_WIN - MEL_HOP
        rs = np.random.RandomState(0)
        t_ax = np.arange(need) / 16000.0
        am = 0.5 * (1 + np.sin(2 * np.pi * 4.0 * t_ax))
        windows = torch.from_numpy(
            (rs.randn(n, 1, need) * 0.1 * am).astype(np.float32)
        ).to(dev)

        def run_steps(_mgr=mgr, _windows=windows) -> torch.Tensor:
            state = _mgr.make_state()
            caches, dec = state.caches, state.dec_state
            last = torch.zeros((1,), dtype=torch.float32, device=dev)
            counts = []
            for window in _windows:
                result, last, caches, dec = _mgr._chunk_step(window, last, caches, dec)
                counts.append(result.counts)
            return torch.stack(counts)

        with torch.no_grad():
            counts = run_steps()  # warm-up
            best = float("inf")
            for _ in range(args.iters):
                if dev.type == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize(dev)
                    start.record()
                    counts = run_steps()
                    end.record()
                    torch.cuda.synchronize(dev)
                    best = min(best, start.elapsed_time(end) / 1e3)
                else:
                    t0 = time.perf_counter()
                    counts = run_steps()
                    best = min(best, time.perf_counter() - t0)
        per_chunk_ms = best / n * 1000

        # single-dispatch distribution for comparison
        singles = []
        st = mgr.make_state()
        host_windows = windows.cpu().numpy()
        for i in range(min(n, 16)):
            t0 = time.perf_counter()
            mgr.process(host_windows[i, 0, : mgr.chunk_samples], st)
            singles.append((time.perf_counter() - t0) * 1000)
        out[f"eou_{tier}ms"] = {
            "device_per_chunk_ms": round(per_chunk_ms, 3),
            "rt_budget_ms": tier,
            "rt_headroom_x": round(tier / per_chunk_ms, 1),
            "dispatch_p50_ms": round(float(np.percentile(singles, 50)), 1),
            "dispatch_p95_ms": round(float(np.percentile(singles, 95)), 1),
            "tokens_emitted": int(counts.sum()),
        }

    print(json.dumps(out))
    return 0
