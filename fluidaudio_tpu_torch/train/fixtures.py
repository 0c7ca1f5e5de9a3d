"""Trained fixture evaluations on the port: Parakeet TDT, streaming EOU,
Nemotron, CTC, SenseVoice, Paraformer, Cohere, VAD, the diarizers, LS-EEND
and the TTS backends (Kokoro, PocketTTS, StyleTTS2).

Copies of `fluidaudio_tpu/train/fixtures.py` (that module imports JAX): the
same seeds, corpora and gates, run through the port's `AsrManager`,
`StreamingEouAsrManager`, `StreamingNemotronAsrManager`,
`CtcKeywordSpotter`, `ctc_greedy_decode`, `ctc_beam_search`,
`ctc_token_rescore`, `SenseVoiceManager`, `ParaformerManager`,
`CoherePipeline`, `VadManager`, `OfflineDiarizerManager`, `DiarizerManager`,
`SortformerDiarizer`, `LSEENDDiarizer`, `KokoroManager`, `PocketTtsManager` and
`StyleTTS2Manager` on `device`
(None: the GPU; pass "cpu" to run on the CPU). The held-out draws of the
ASR, EOU and Nemotron evaluations are their own functions
(`*_fixture_utterances`), which the tests share. The fixtures themselves are
the JAX package's committed npz (`fluidaudio_tpu/assets/trained_tiny/`),
read as files.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from fluidaudio_tpu_torch.train import tiny_corpus as tc

#: the fixture's vocabulary: 16 tone words at 0..15, blank LAST (id 16 — the
#: parakeet-ctc head layout `KeywordSpotterConfig.blank_id`)
CTC_BLANK_ID = tc.N_WORDS
#: quality gates the fixtures clear (as in the JAX package)
ASR_WER_GATE = 0.02
VAD_F1_GATE = 0.90
KWS_RECALL_GATE = 0.99
KWS_PRECISION_GATE = 0.99
DIAR_DER_GATE = 0.05
#: the online pyannote diarizer (10 s chunks, online nearest-centroid
#: clustering) is held to a looser gate than the offline one
ONLINE_DIAR_DER_GATE = 0.10
#: online clustering threshold tuned to the TRAINED tiny embedding space
#: (same-speaker cosine distance ~1e-5, cross-speaker ~0.54: new speakers
#: past 0.25*1.2 = 0.30; the reference default 0.7 suits the real 256-d space)
ONLINE_DIAR_CLUSTER_THRESHOLD = 0.25
#: offline AHC warm-start cut tuned to the same trained space: same-speaker
#: centroid merges at cosine distance <= 0.003, the cross-speaker merge at
#: ~0.595, so 0.30 cuts in the middle (the default 0.6 is the real-WeSpeaker
#: value and sits a hair above the cross merge here)
OFFLINE_AHC_THRESHOLD = 0.30
#: the online attractor diarizer (900 ms warm-up suppressed) on the same
#: corpus is held to the online gate
LSEEND_DER_GATE = 0.10


def trained_assets_dir() -> Path:
    """The committed trained fixtures (they live beside the JAX package)."""
    return Path(__file__).resolve().parents[2] / "fluidaudio_tpu" / "assets" / "trained_tiny"


_CORE_FAMILIES = ("asr", "vad", "sortformer")

_FIXTURE_FILES = {
    "asr": ("asr/encoder.npz", "asr/predictor.npz", "asr/joint.npz",
            "asr/vocab.json"),
    "vad": ("vad/silero_vad.npz",),
    "sortformer": ("sortformer/encoder.npz",),
    "sensevoice": ("sensevoice/encoder.npz", "sensevoice/vocab.json"),
    "paraformer": ("paraformer/model.npz", "paraformer/vocab.json"),
    "cohere": ("cohere/encoder.npz", "cohere/decoder.npz", "cohere/vocab.json"),
    "eou": ("eou/encoder.npz", "eou/predictor.npz", "eou/joint.npz",
            "eou/vocab.json"),
    "lseend": ("lseend/model.npz",),
    "offline": ("offline/segmentation.npz", "offline/embedding.npz",
                "offline/plda_rho.npz"),
    "nemotron": ("nemotron/encoder.npz", "nemotron/predictor.npz",
                 "nemotron/joint.npz", "nemotron/vocab.json",
                 "nemotron/metadata.json"),
    "ctc": ("ctc/encoder.npz", "ctc/ctc_head.npz", "ctc/vocab.json"),
    "tts": ("tts/text.npz", "tts/audio.npz", "tts/voices.npz"),
    "pocket": ("pocket/flowlm.npz", "pocket/flow.npz", "pocket/mimi.npz",
               "pocket/mimi_enc.npz", "pocket/voices.npz"),
    "styletts2": ("styletts2/text.npz", "styletts2/style.npz",
                  "styletts2/predict.npz", "styletts2/acoustic.npz"),
}


def fixtures_available(*families: str) -> bool:
    """No args = the three core families (ASR/VAD/sortformer)."""
    base = trained_assets_dir()
    for fam in families or _CORE_FAMILIES:
        if not all((base / f).exists() for f in _FIXTURE_FILES[fam]):
            return False
    return True


# ------------------------------------------------------------------------
# Tiny per-family fixture conventions (one source of truth for token-id
# maps and configs, as in the JAX package)
# ------------------------------------------------------------------------

#: SenseVoice: CTC blank is id 0 (FunASR convention), words at 1..16
SENSEVOICE_WORD_OFFSET = 1
#: Paraformer: id 0 reserved as pad, words at 1..16
PARAFORMER_WORD_OFFSET = 1
#: Cohere: ids 0-4 are special (pad 2, eos 3, bos 4), words at 5..20
COHERE_WORD_OFFSET = 5
#: Nemotron multilingual tiny: language A (pure tones, "w*") at 0..15,
#: language B (harmonic, "v*") at 16..31, lang tags <aa-AA>/<bb-BB> at 32/33,
#: blank 34; prompt ids {auto: 0, aa-AA: 1, bb-BB: 2}
NEMOTRON_B_OFFSET = 16
NEMOTRON_TAG_A = 32
NEMOTRON_TAG_B = 33


# ------------------------------------------------- Parakeet TDT (batch)


def asr_fixture_utterances(n_words: tuple[int, ...] = (5, 40), seed: int = 12345
                           ) -> list[tuple[np.ndarray, np.ndarray]]:
    """The held-out draws of `eval_asr_fixture`: (word ids, audio) per length."""
    rs = np.random.RandomState(seed)
    out = []
    for n in n_words:
        ids = rs.randint(0, tc.N_WORDS, size=n)
        out.append((ids, tc.make_utterance(ids, rs)))
    return out


def eval_asr_fixture(n_words: tuple[int, ...] = (5, 40), seed: int = 12345, batch: int = 2,
                     *, device=None) -> dict[str, float]:
    """WER through the FULL AsrManager.transcribe path (chunked long-form,
    silence-aligned starts, seam merge) on held-out utterances of the
    trained 16-tone-word language. Returns per-length + average WER."""
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.metrics.wer import wer
    from fluidaudio_tpu_torch.models.zoo import AsrModels

    models = AsrModels.load(
        "test-tiny", checkpoint_dir=trained_assets_dir() / "asr",
        allow_random_init=False, device=device,
    )
    mgr = AsrManager(models, ASRConfig(parallel_chunk_batch=batch))
    out: dict[str, float] = {}
    rates = []
    for n, (ids, audio) in zip(n_words, asr_fixture_utterances(n_words, seed)):
        r = wer(tc.transcript_text(ids), mgr.transcribe(audio).text).rate
        out[f"wer_{n}w"] = r
        rates.append(r)
    out["wer_avg"] = float(np.mean(rates))
    return out


# ---------------------------------------------------- streaming EOU, Nemotron
#: the open-mic silence after each utterance of the EOU evaluation: EOU is
#: silence-driven (reference ParakeetEouCommand.swift:22), and the trained
#: detection deadline is ~1 s after the utterance ends
EOU_TAIL_SECONDS = 1.28


def eou_fixture_utterances(seed: int = 2468, n_utts: int = 6
                           ) -> list[tuple[np.ndarray, np.ndarray]]:
    """The held-out draws of `eval_eou_fixture`: (word ids, audio followed by
    `EOU_TAIL_SECONDS` of silence)."""
    rs = np.random.RandomState(seed)
    tail = np.zeros(int(EOU_TAIL_SECONDS * 16_000), np.float32)
    out = []
    for _ in range(n_utts):
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 8)))
        out.append((ids, np.concatenate([tc.make_utterance(ids, rs), tail])))
    return out


def eval_eou_fixture(seed: int = 2468, n_utts: int = 6, *, device=None) -> dict[str, float]:
    """WER + EOU-detection rate through the FULL StreamingEouAsrManager path
    (chunked feed, mel pre-cache, conformer channel/time caches, incremental
    RNN-T decode, finish() flush) on held-out utterances at the trained
    320 ms tier. The EOU token must fire (debounced flag) for each utterance
    and must NOT leak into the transcript text."""
    from fluidaudio_tpu_torch.asr.streaming_eou import EOU_TEST, StreamingEouAsrManager
    from fluidaudio_tpu_torch.metrics.wer import wer

    eou_events: list = []
    mgr = StreamingEouAsrManager(
        chunk_ms=320, spec=EOU_TEST,
        checkpoint_dir=trained_assets_dir() / "eou",
        on_eou=lambda p: eou_events.append(p), device=device,
    )
    rates, detected = [], 0
    for ids, audio in eou_fixture_utterances(seed, n_utts):
        state = mgr.make_state()
        eou_events.clear()
        mgr.process(audio, state)
        final = mgr.finish(state)
        rates.append(wer(tc.transcript_text(ids), final.text).rate)
        detected += bool(eou_events)
    return {"wer_avg": float(np.mean(rates)),
            "eou_detect_rate": detected / n_utts}


def nemotron_tiny_enc_cfg():
    """Streaming-conformer size for the NEMOTRON_TEST fixture (matches the
    EOU_TEST encoder so both streaming families share convention coverage)."""
    from fluidaudio_tpu_torch.models.conformer_streaming import StreamingConformerConfig

    return StreamingConformerConfig(
        d_model=64, n_layers=2, n_heads=4, subsampling_channels=32,
        att_context_left=16,
    )


def nemotron_fixture_utterances(seed: int = 9753, n_utts: int = 6
                                ) -> list[tuple[str, str, np.ndarray]]:
    """The held-out draws of `eval_nemotron_fixture`: (prompt language
    "aa-AA"/"bb-BB", reference text, audio); the languages alternate."""
    rs = np.random.RandomState(seed)
    out = []
    for u in range(n_utts):
        lang = "a" if u % 2 == 0 else "b"
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 8)))
        audio = tc.make_utterance(ids, rs, lang=lang)
        words = (tc.word_text(i) if lang == "a" else tc.word_text_b(i) for i in ids)
        out.append(("aa-AA" if lang == "a" else "bb-BB", " ".join(words), audio))
    return out


def eval_nemotron_fixture(seed: int = 9753, n_utts: int = 6, *, device=None
                          ) -> dict[str, float]:
    """The multilingual streaming contract through the FULL manager:
    per-language WER with explicit prompts, and auto-mode language detection
    (leading <xx-XX> tag parsed + filtered from text) on the same audio.
    Reference: StreamingNemotronMultilingualAsrManager + FLEURS benchmark
    semantics."""
    from fluidaudio_tpu_torch.asr.streaming_nemotron import (
        NEMOTRON_TEST, StreamingNemotronAsrManager,
    )
    from fluidaudio_tpu_torch.metrics.wer import wer

    mgr = StreamingNemotronAsrManager(
        NEMOTRON_TEST, 560, language="auto", enc_cfg=nemotron_tiny_enc_cfg(),
        checkpoint_dir=trained_assets_dir() / "nemotron", device=device,
    )
    rates, detected = [], 0
    for lang, ref, audio in nemotron_fixture_utterances(seed, n_utts):
        # explicit prompt for this language
        mgr.set_language(lang)
        state = mgr.make_state()
        mgr.process(audio, state)
        rates.append(wer(ref, mgr.finish(state).text).rate)

        # auto-detect mode on the same audio
        mgr.set_language("auto")
        state = mgr.make_state()
        mgr.process(audio, state)
        mgr.finish(state)
        detected += state.detected_language == lang
    return {"wer_avg": float(np.mean(rates)),
            "lang_detect_rate": detected / n_utts}


def ctc_tiny_enc_cfg():
    """Offline-conformer size of the CTC fixture (the zoo `test-tiny`
    encoder: d 64, 2 layers, 4 heads, Dh 16, f32)."""
    from fluidaudio_tpu_torch.models.conformer import ConformerConfig

    return ConformerConfig(d_model=64, n_layers=2, n_heads=4,
                           subsampling_channels=32, dtype="float32")


def _ctc_spotter(terms=None, device=None):
    from fluidaudio_tpu_torch.asr.custom_vocab.context import (
        CustomVocabularyContext, VocabularyTerm,
    )
    from fluidaudio_tpu_torch.asr.keyword_spotter import (
        CtcKeywordSpotter, KeywordSpotterConfig,
    )
    from fluidaudio_tpu_torch.asr.tokenizer import Tokenizer

    ckpt = trained_assets_dir() / "ctc"
    tok = Tokenizer.from_json(ckpt / "vocab.json")
    ctx = CustomVocabularyContext(
        [VocabularyTerm(text=t) for t in (terms or [])], tok,
        min_term_length=2,
    )
    spotter = CtcKeywordSpotter(
        ctx, KeywordSpotterConfig(vocab_size=tc.N_WORDS),
        encoder_cfg=ctc_tiny_enc_cfg(), checkpoint_dir=ckpt, device=device,
    )
    return spotter, tok


def _greedy(canvas: np.ndarray, device) -> tuple[list[int], list[int]]:
    """Greedy CTC over one [T, V+1] canvas on `device` -> (ids, frames)."""
    from fluidaudio_tpu_torch.ops.ctc_decode import ctc_greedy_decode

    toks, frames, counts = ctc_greedy_decode(
        torch.from_numpy(canvas)[None].to(device),
        torch.tensor([len(canvas)], device=device), CTC_BLANK_ID)
    n = int(counts[0])
    return ([int(t) for t in toks[0, :n].cpu().numpy()],
            [int(f) for f in frames[0, :n].cpu().numpy()])


def eval_ctc_fixture(seed: int = 24680, n_utts: int = 3, *, device=None) -> dict[str, float]:
    """Greedy CTC decode WER on the trained posteriors + prefix-beam-search
    agreement (the CtcDecoder/ARPA stack's acoustic front, reference
    `CtcAsrManager` greedy path + Earnings22 CTC benchmark)."""
    from fluidaudio_tpu_torch.metrics.wer import wer
    from fluidaudio_tpu_torch.ops.ctc_decode import ctc_beam_search

    spotter, tok = _ctc_spotter(device=device)
    rs = np.random.RandomState(seed)
    rates, beam_agree = [], 0
    # 38 words ≈ 16 s: crosses the 15 s chunk boundary, so the greedy WER
    # also covers the logmeanexp overlap-merge seam
    for n in (6, 20, 38)[:n_utts]:
        ids = rs.randint(0, tc.N_WORDS, size=n)
        audio = tc.make_utterance(ids, rs)
        canvas = spotter.log_probs(audio)
        greedy_ids, _ = _greedy(canvas, spotter.device)
        rates.append(wer(tc.transcript_text(ids), tok.decode(greedy_ids)).rate)
        beam_ids = ctc_beam_search(canvas, CTC_BLANK_ID, beam_width=4)
        beam_agree += beam_ids == greedy_ids
    return {"wer_avg": float(np.mean(rates)),
            "beam_agree_rate": beam_agree / n_utts}


def eval_ctc_spotting_fixture(seed: int = 13579, *, device=None) -> dict[str, float]:
    """Functional keyword spotting through the FULL CtcKeywordSpotter path
    (chunked 15 s windows, logmeanexp overlap merge, per-keyword DP):
    multi-word terms planted ONCE in a long recording among disjoint
    background words must spot at the right frames; an absent term must not
    spot at all. Reference `WordSpotting/CtcKeywordSpotter.swift` +
    Earnings22-KWS benchmark semantics."""
    rs = np.random.RandomState(seed)
    # keyword words 0..7, background words 8..15: no accidental occurrences
    planted = [("w0 w3", [0, 3]), ("w5", [5]), ("w1 w2 w6", [1, 2, 6])]
    absent = "w4 w7"
    word_span = tc.WORD_SEC + tc.GAP_SEC

    # 34 background + 6 planted words ≈ 17 s: the spot canvas spans two
    # 15 s chunks, so DP search runs over a logmeanexp-merged seam
    seq: list[int] = list(rs.randint(8, tc.N_WORDS, size=34))
    slots = sorted(rs.choice(len(seq), size=len(planted), replace=False))
    starts: dict[str, int] = {}  # term -> word index in final sequence
    grown = 0
    for slot, (term, term_ids) in zip(slots, planted):
        pos = slot + grown
        seq[pos:pos] = term_ids
        starts[term] = pos
        grown += len(term_ids)
    audio = tc.make_utterance(np.asarray(seq), rs)

    spotter, _ = _ctc_spotter([t for t, _ in planted] + [absent], device=device)
    spots = {s.keyword: s for s in spotter.spot(audio)}

    hits, timing_ok = 0, 0
    for term, term_ids in planted:
        s = spots.get(term)
        if s is None:
            continue
        hits += 1
        # expected encoder-frame window (80 ms frames; 0.10 s lead)
        t0 = (0.10 + starts[term] * word_span) / 0.080
        t1 = t0 + len(term_ids) * word_span / 0.080
        timing_ok += (s.start_frame >= t0 - 4) and (s.end_frame <= t1 + 4)
    false_alarms = int(absent in spots)
    n_spots = len(spots)
    return {
        "recall": hits / len(planted),
        "precision": (n_spots - false_alarms) / max(n_spots, 1),
        "timing_rate": timing_ok / len(planted),
    }


def eval_vocab_boost_fixture(seed: int = 555, *, device=None) -> dict[str, float]:
    """End-to-end vocabulary-boost WER-improvement proof on the TRAINED CTC
    fixture: a forced misrecognition is CORRECTED by `ctc_token_rescore`,
    and a decoy term must NOT over-fire on a correctly-recognized word.

    One slot renders the true word `w12` under stronger `w13` interference
    (a 60/40 blend of the two tones), so greedy CTC decodes `w13`; the
    vocabulary carries `w12` with alias `w13` plus a decoy `w0` aliased to
    the correctly-spoken `w8`, which only the acoustic CTC-vs-CTC gate can
    reject. Everything runs the DEFAULT RescorerConfig (the JAX function's
    docstring gives the construction in full)."""
    from fluidaudio_tpu_torch.asr.custom_vocab.context import (
        CustomVocabularyContext, VocabularyTerm,
    )
    from fluidaudio_tpu_torch.asr.custom_vocab.rescorer import (
        WordTiming, ctc_token_rescore,
    )
    from fluidaudio_tpu_torch.metrics.wer import wer

    spotter, tok = _ctc_spotter(device=device)
    rs = np.random.RandomState(seed)
    truth = [5, 8, 12, 1, 2, 14]
    confused_slot, true_word = 2, 12

    # build the waveform by hand so the confused slot carries the blend
    lead = int(0.10 * tc.SR)
    gap = np.zeros(int(tc.GAP_SEC * tc.SR), np.float32)
    parts = [np.zeros(lead, np.float32)]
    for slot, w in enumerate(truth):
        if slot == confused_slot:
            blend = (0.6 * tc.word_audio(13, amp=1.0)
                     + 0.4 * tc.word_audio(true_word, amp=1.0))
            parts.append((0.35 * blend).astype(np.float32))
        else:
            parts.append(tc.word_audio(int(w), amp=float(rs.uniform(0.25, 0.45))))
        parts.append(gap)
    audio = np.concatenate(parts)
    audio += rs.randn(audio.size).astype(np.float32) * 0.002

    canvas = spotter.log_probs(audio)  # [T, V+1] merged log-probs
    hyp_ids, hyp_frames = _greedy(canvas, spotter.device)
    frame_dur = 0.080
    word_span = tc.WORD_SEC + tc.GAP_SEC
    timings = [
        WordTiming(word=tc.word_text(i), start_time=f * frame_dur,
                   end_time=f * frame_dur + word_span)
        for i, f in zip(hyp_ids, hyp_frames)
    ]
    truth_text = tc.transcript_text(truth)
    before = " ".join(t.word for t in timings)

    ctx = CustomVocabularyContext(
        [VocabularyTerm(text=tc.word_text(true_word), aliases=["w13"]),
         # decoy: alias exact-matches the correctly-spoken w8, but w0 is
         # acoustically absent — only the CTC-vs-CTC gate can reject it
         VocabularyTerm(text="w0", aliases=["w8"])],
        tok, min_term_length=2,
    )
    out = ctc_token_rescore(
        timings, canvas, frame_dur, ctx, tok, blank_id=CTC_BLANK_ID)
    return {
        "wer_before": wer(truth_text, before).rate,
        "wer_after": wer(truth_text, out.text).rate,
        "corrected": float(any(
            r.replacement == tc.word_text(true_word) for r in out.replacements
        )),
        "false_boost": float("w0" in out.text.split()),
    }


def cohere_tiny_config():
    """COHERE_TEST widened to a usable audio window (5.12 s) so multi-word
    utterances fit, and to 32 mel bins — 16 bins over 0-8 kHz cannot separate
    the two lowest tone words (240 vs 290 Hz land in one bin). Everything
    else stays test-tiny."""
    from dataclasses import replace

    from fluidaudio_tpu_torch.models.cohere_asr import COHERE_TEST

    return replace(COHERE_TEST, max_audio_frames=512, max_decode_tokens=16,
                   n_mels=32)


def write_family_vocab(path: Path, offset: int, specials: dict[int, str]) -> None:
    """id -> piece JSON: 16 tone words at `offset`, named specials, fillers."""
    import json

    vocab = dict(specials)
    for i in range(tc.N_WORDS):
        vocab[offset + i] = "▁" + tc.word_text(i)
    for i in range(64):
        vocab.setdefault(i, f"▁unused{i}")
    path.write_text(json.dumps({str(k): v for k, v in sorted(vocab.items())},
                               ensure_ascii=False))


def _family_wer(mgr, seed: int, n_utts: int, max_words: int) -> float:
    from fluidaudio_tpu_torch.metrics.wer import wer

    rs = np.random.RandomState(seed)
    rates = []
    for _ in range(n_utts):
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, max_words)))
        audio = tc.make_utterance(ids, rs)
        rates.append(wer(tc.transcript_text(ids), mgr.transcribe(audio).text).rate)
    return float(np.mean(rates))


def eval_sensevoice_fixture(seed: int = 321, n_utts: int = 6, *, device=None) -> float:
    """WER through SenseVoiceManager.transcribe (mel -> LFR -> SANM -> CTC
    greedy, bucketed shapes, tag stripping) on held-out utterances."""
    from fluidaudio_tpu_torch.asr.sensevoice_manager import SenseVoiceManager
    from fluidaudio_tpu_torch.models.sensevoice import SENSEVOICE_TEST

    mgr = SenseVoiceManager(SENSEVOICE_TEST, checkpoint_dir=trained_assets_dir() / "sensevoice",
                            device=device)
    return _family_wer(mgr, seed, n_utts, 9)


def eval_paraformer_fixture(seed: int = 654, n_utts: int = 6, *, device=None) -> float:
    """WER through ParaformerManager.transcribe (LFR -> SANM -> CIF ->
    parallel decoder) on held-out utterances."""
    from fluidaudio_tpu_torch.asr.paraformer_manager import ParaformerManager
    from fluidaudio_tpu_torch.models.paraformer import PARAFORMER_TEST

    mgr = ParaformerManager(PARAFORMER_TEST, checkpoint_dir=trained_assets_dir() / "paraformer",
                            device=device)
    return _family_wer(mgr, seed, n_utts, 9)


def eval_cohere_fixture(seed: int = 987, n_utts: int = 6, *, device=None) -> float:
    """WER through CoherePipeline.transcribe (conformer encoder -> KV-cache
    AR decode with repetition penalty) on held-out utterances."""
    from fluidaudio_tpu_torch.asr.cohere_manager import CoherePipeline

    mgr = CoherePipeline(cohere_tiny_config(), checkpoint_dir=trained_assets_dir() / "cohere",
                         device=device)
    return _family_wer(mgr, seed, n_utts, 8)


def vad_fixture_clips(seed: int = 777, clips: int = 12) -> list[tuple[bool, np.ndarray]]:
    """The held-out clips of `eval_vad_fixture`: (is speech, samples)."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(clips):
        speech = i % 2 == 0
        if speech:
            clip = tc.speechish(2.0, rs) if i % 4 == 0 else tc.make_utterance(
                rs.randint(0, tc.N_WORDS, size=4), rs, noise=0.0)
        else:
            clip = (rs.randn(32000) * 0.003).astype(np.float32)
        out.append((speech, clip))
    return out


def eval_vad_fixture(seed: int = 777, clips: int = 12, *, device=None) -> float:
    """Clip-level F1 of the trained tiny Silero through VadManager.process
    on held-out synthetic speech/nonspeech."""
    from fluidaudio_tpu_torch.vad import VadManager

    mgr = VadManager(checkpoint_dir=trained_assets_dir() / "vad", device=device)
    tp = fp = fn = 0
    for speech, clip in vad_fixture_clips(seed, clips):
        results = mgr.process(clip)
        pred = bool(np.mean([r.probability for r in results]) >= 0.5)
        tp += pred and speech
        fp += pred and not speech
        fn += (not pred) and speech
    return 2 * tp / max(2 * tp + fp + fn, 1)


# ----------------------------------------------------------------- diarizers


def _der(result, ref) -> float:
    from fluidaudio_tpu_torch.diarizer.metrics import compute_der
    from fluidaudio_tpu_torch.diarizer.types import TimedSpeakerSegment

    refs = [TimedSpeakerSegment(speaker_id=s, start_time=a, end_time=b) for s, a, b in ref]
    return compute_der(refs, result.segments, collar=0.25).der


def eval_sortformer_fixture(seed: int = 4242, seconds: float = 60.0, *, device=None) -> float:
    """DER of the trained tiny Sortformer through `process_offline` (windowing,
    speaker-slot stitching, segment reconstruction) on a held-out 2-speaker
    synthetic mixture."""
    from fluidaudio_tpu_torch.diarizer.sortformer import SortformerDiarizer
    from fluidaudio_tpu_torch.models.sortformer import SORTFORMER_TEST

    rs = np.random.RandomState(seed)
    mix, ref, _ = tc.diarizer_mixture(rs, seconds, overlap_prob=0.0)
    diar = SortformerDiarizer(SORTFORMER_TEST, checkpoint_dir=trained_assets_dir() / "sortformer",
                              device=device)
    return _der(diar.process_offline(mix), ref)


def offline_tiny_configs():
    """(SegmentationConfig, WeSpeakerConfig) of the trained offline-diarizer
    fixture: the shipping topologies at reduced widths and depths."""
    from fluidaudio_tpu_torch.models.pyannote_seg import SegmentationConfig
    from fluidaudio_tpu_torch.models.wespeaker import WeSpeakerConfig

    seg = SegmentationConfig(conv_channels=(16, 32, 32, 32), d_model=32,
                             n_attention_layers=1, n_heads=4)
    emb = WeSpeakerConfig(channels=(8, 16, 32, 32),
                          blocks_per_stage=(1, 1, 1, 1), embedding_dim=32)
    return seg, emb


def offline_diarizer_config():
    """OfflineDiarizerConfig with the AHC cut tuned to the trained tiny
    embedding space (`OFFLINE_AHC_THRESHOLD`); everything else default."""
    from fluidaudio_tpu_torch.diarizer.offline.types import (
        ClusteringOptions, OfflineDiarizerConfig,
    )

    return OfflineDiarizerConfig(
        clustering=ClusteringOptions(ahc_threshold=OFFLINE_AHC_THRESHOLD),
    )


def offline_diarizer_manager(config=None, *, device=None):
    """OfflineDiarizerManager over the trained tiny checkpoints with the
    fixture-tuned clustering config (pass `config` to override)."""
    from fluidaudio_tpu_torch.diarizer.offline.manager import OfflineDiarizerManager

    seg_cfg, emb_cfg = offline_tiny_configs()
    return OfflineDiarizerManager(
        config or offline_diarizer_config(),
        checkpoint_dir=trained_assets_dir() / "offline",
        seg_config=seg_cfg, emb_config=emb_cfg, device=device,
    )


def eval_offline_diarizer_fixture(seed: int = 13579, seconds: float = 60.0, *,
                                  device=None) -> float:
    """DER through the full offline pipeline on the trained tiny models:
    batched powerset segmentation -> masked-stats embeddings -> fitted PLDA
    -> AHC warm start -> VBx HMM refinement -> segment reconstruction."""
    mgr = offline_diarizer_manager(device=device)
    rs = np.random.RandomState(seed)
    mix, ref, _ = tc.diarizer_mixture(rs, seconds, overlap_prob=0.0)
    return _der(mgr.process(mix), ref)


def online_diarizer_manager(*, device=None):
    """Streaming pyannote DiarizerManager over the trained OFFLINE
    segmentation/embedding checkpoints (the reference shares these models
    between its online and offline diarizers), with the online clustering
    threshold tuned to the trained embedding space."""
    from fluidaudio_tpu_torch.diarizer.manager import DiarizerManager
    from fluidaudio_tpu_torch.diarizer.types import DiarizerConfig

    seg_cfg, emb_cfg = offline_tiny_configs()
    return DiarizerManager(
        DiarizerConfig(clustering_threshold=ONLINE_DIAR_CLUSTER_THRESHOLD),
        checkpoint_dir=trained_assets_dir() / "offline",
        seg_config=seg_cfg, emb_config=emb_cfg, device=device,
    )


def eval_online_diarizer_fixture(seed: int = 97531, seconds: float = 60.0, *,
                                 device=None) -> dict[str, float]:
    """DER + online speaker count through `DiarizerManager.process` (10 s
    chunks -> powerset segmentation -> clean-frame masks -> masked
    embeddings -> online nearest-centroid SpeakerManager -> overlap-aware
    segments) on a held-out 2-speaker mixture."""
    mgr = online_diarizer_manager(device=device)
    rs = np.random.RandomState(seed)
    mix, ref, _ = tc.diarizer_mixture(rs, seconds, overlap_prob=0.0)
    result = mgr.process(mix)
    return {"der": float(_der(result, ref)), "speaker_count": float(result.speaker_count)}


def eval_lseend_fixture(seed: int = 8642, seconds: float = 60.0, *, device=None) -> float:
    """DER of the trained tiny LS-EEND through the FULL LSEENDDiarizer.process
    path (16 kHz resample -> per-step mel+CMN -> recurrent attractor steps ->
    segment reconstruction) on a held-out 2-speaker mixture. Online model:
    the 900 ms warm-up suppression is part of the measured DER."""
    from fluidaudio_tpu_torch.diarizer.lseend import LSEENDDiarizer
    from fluidaudio_tpu_torch.models.lseend import LSEEND_TEST

    rs = np.random.RandomState(seed)
    mix, ref, _ = tc.diarizer_mixture(rs, seconds, overlap_prob=0.0)
    diar = LSEENDDiarizer(LSEEND_TEST, step_ms=500,
                          checkpoint_dir=trained_assets_dir() / "lseend", device=device)
    return _der(diar.process(mix), ref)


# --------------------------------------------------------------------- TTS
#: Kokoro tiny fixture conventions: tone word i renders as IPA letter
#: 'a'+i (all 16 in the 178-symbol StyleTTS2 table); custom-lexicon entries
#: map the text words "w0".."w15" onto them. 25 ms acoustic frames (HOP 600
#: @ 24 kHz): a word is 12 frames of tone, the inter-word space 5 frames,
#: the BOS/EOS pad symbol 1 frame of silence each.
TTS_WORD_SYMBOLS = "abcdefghijklmnop"
TTS_WORD_FRAMES = 12
TTS_GAP_FRAMES = 5
TTS_PAD_FRAMES = 1
#: roundtrip gate: synthesized speech must be transcribed by the trained
#: ASR fixture at ~0 WER (the reference's tts-asr-verify CLI contract); the
#: JAX reference itself does not clear it (ROADMAP Queue C)
TTS_ROUNDTRIP_WER_GATE = 0.02


def kokoro_tiny_config():
    """The JAX package's tiny KokoroConfig of the trained `tts` fixture: the
    full topology at fixture scale, pinned to the fixed 160-frame grid it
    was trained on (the generator's instance-norm statistics see the padded
    grid), f0_scale 500 and phase_scale pi for the tone corpus, and the
    iSTFT head at hop 1 (rates (20, 15), prod(rates) * hop = 300 keeps the
    manager's HOP = 600)."""
    from fluidaudio_tpu_torch.models.kokoro import KokoroConfig

    return KokoroConfig(
        d_model=64, n_layer=1,
        albert_emb=32, albert_hidden=64, albert_heads=4, albert_inter=128,
        albert_layers=2,
        decoder_hidden=64, asr_res_ch=16, upsample_initial=64,
        resblock_kernels=(3, 7), resblock_dilations=((1, 3), (1, 3)),
        max_frames=384,
        frame_buckets=(160,),
        f0_scale=500.0, phase_scale=float(np.pi),
        upsample_rates=(20, 15), upsample_kernels=(40, 31), gen_hop=1,
    )


def tts_lexicon() -> dict[str, str]:
    """Custom-lexicon entries wiring the tone-word texts to their symbols."""
    return {tc.word_text(i): TTS_WORD_SYMBOLS[i] for i in range(tc.N_WORDS)}


def tts_durations(n_words: int) -> np.ndarray:
    """Ground-truth per-token frame durations for the wrapped id sequence
    [pad, sym, space, sym, ..., sym, pad]."""
    out = [TTS_PAD_FRAMES]
    for w in range(n_words):
        out.append(TTS_WORD_FRAMES)
        out.append(TTS_GAP_FRAMES if w + 1 < n_words else TTS_PAD_FRAMES)
    return np.asarray(out, np.float32)


def load_tts_manager(*, device=None):
    from fluidaudio_tpu_torch.tts.kokoro_manager import KokoroManager

    mgr = KokoroManager(
        variant="english", default_voice="af_test",
        checkpoint_dir=trained_assets_dir() / "tts",
        config=kokoro_tiny_config(), device=device,
    )
    mgr.set_english_custom_lexicon(tts_lexicon())
    return mgr


def eval_tts_fixture(seed: int = 8642, n_utts: int = 3, *, device=None) -> dict:
    """The full synthesis contract: text -> custom-lexicon G2P -> duration ->
    prosody/vocoder -> 24 kHz samples -> post-process, then CLOSED LOOP
    through the trained ASR fixture after 24->16 kHz resampling (the
    reference's `tts-asr-verify`), and the mean absolute duration error in
    frames on the same phoneme sequences (rounding-safe is < 0.5), and each
    utterance's (text, transcript) under `"utterances"`."""
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.zoo import AsrModels
    from fluidaudio_tpu_torch.tts.roundtrip import TINY_CORPUS_CHANNEL, tts_asr_roundtrip

    tts = load_tts_manager(device=device)
    asr = AsrManager(
        AsrModels.load("test-tiny", checkpoint_dir=trained_assets_dir() / "asr",
                       allow_random_init=False, device=device),
        ASRConfig(),
    )
    rs = np.random.RandomState(seed)
    rates, dur_errs, utterances = [], [], []
    for _ in range(n_utts):
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 9)))
        text = tc.transcript_text(ids)
        r = tts_asr_roundtrip(tts, asr, text, channel=TINY_CORPUS_CHANNEL)
        rates.append(r.wer)
        utterances.append((r.text, r.transcript))
        # duration head accuracy on the same phoneme sequence, at JAX's
        # 32-token grid
        phonemes = " ".join(TTS_WORD_SYMBOLS[int(i)] for i in ids)
        tok = [0, *tts.encode_phonemes(phonemes), 0]
        tokens = np.zeros((1, 32), np.int64)
        tokens[0, : len(tok)] = tok
        style_s = torch.as_tensor(tts.voices["af_test"][len(phonemes) - 1][128:][None]).to(
            tts.device)
        dur, _, _ = tts.text_program(
            torch.as_tensor(tokens).to(tts.device),
            torch.tensor([len(tok)], dtype=torch.int32, device=tts.device), style_s, 1.0)
        got = dur[0, : len(tok)].cpu().numpy()
        dur_errs.append(float(np.abs(got - tts_durations(len(ids))).mean()))
    return {"roundtrip_wer_avg": float(np.mean(rates)),
            "dur_mae_frames": float(np.mean(dur_errs)), "utterances": utterances}


def tts_target_audio(word_ids: np.ndarray, total_frames: int) -> np.ndarray:
    """Construction target at 24 kHz: per-frame silence/tone layout matching
    `tts_durations`, tone frequencies on the ASR corpus grid (`word_freq`)."""
    from fluidaudio_tpu_torch.models.kokoro import HOP, SAMPLE_RATE

    parts = [np.zeros(TTS_PAD_FRAMES * HOP, np.float32)]
    for k, w in enumerate(word_ids):
        n = TTS_WORD_FRAMES * HOP
        t = np.arange(n) / SAMPLE_RATE
        sig = 0.35 * np.sin(2 * np.pi * tc.word_freq(int(w)) * t)
        ramp = int(0.010 * SAMPLE_RATE)
        env = np.ones(n, np.float32)
        env[:ramp] = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
        env[-ramp:] = env[:ramp][::-1]
        parts.append((sig * env).astype(np.float32))
        gap = TTS_GAP_FRAMES if k + 1 < len(word_ids) else TTS_PAD_FRAMES
        parts.append(np.zeros(gap * HOP, np.float32))
    audio = np.concatenate(parts)
    out = np.zeros(total_frames * HOP, np.float32)
    out[: min(audio.size, out.size)] = audio[: out.size]
    return out


def _linear_resize_np(x: np.ndarray, out_len: int) -> np.ndarray:
    """numpy mirror of models.kokoro.linear_resize (align_corners=False)."""
    in_len = x.shape[0]
    scale = in_len / out_len
    pos = (np.arange(out_len) + 0.5) * scale - 0.5
    lo = np.clip(np.floor(pos).astype(np.int64), 0, in_len - 1)
    hi = np.clip(lo + 1, 0, in_len - 1)
    frac = np.clip(pos - lo, 0.0, 1.0).astype(np.float32)
    return x[lo] + (x[hi] - x[lo]) * frac


def tts_source_phase(f0_2f: np.ndarray, variant: str = "kokoro") -> np.ndarray:
    """Fundamental phase track EXACTLY as the harmonic source accumulates it:
    a cumsum over the F0 track that never resets (each word inherits the
    accumulated phase of every word before it) and freezes through silence
    (f0=0 adds nothing).

    variant="kokoro": models.kokoro.SourceModule — instantaneous frequency
    downsampled to the 2F frame rate (linear_resize), cumsum at frame rate,
    re-upsampled linearly (x300).
    variant="styletts2": models.styletts2.HifiSourceModule — plain
    per-sample cumsum with the %1 cycle bound.

    f0_2f: [2F] Hz track at the prosody head's 2x frame rate (300-sample
    steps at 24 kHz). Returns phase [2F*300] in radians (float32, matching
    the on-device accumulation).
    """
    f0_up = np.repeat(f0_2f.astype(np.float32), 300)
    rad = (f0_up / 24_000.0) % 1.0
    if variant == "styletts2":
        ph = np.cumsum(rad.astype(np.float32), dtype=np.float32) % 1.0
        return ph * np.float32(2.0 * np.pi)
    L = f0_up.size
    rad_f = _linear_resize_np(rad, L // 300)
    ph = np.cumsum(rad_f, dtype=np.float32) * np.float32(2.0 * np.pi)
    return _linear_resize_np(ph * np.float32(300.0), L)


def tts_target_audio_aligned(
    word_ids: np.ndarray, total_frames: int, variant: str = "kokoro",
) -> tuple[np.ndarray, np.ndarray]:
    """Training-only construction target with SOURCE-aligned phase: the word
    and gap frame layout and 10 ms amplitude ramps of `tts_target_audio`,
    with the tone phase `tts_source_phase` of the ground-truth F0 track (so
    with teacher-forced F0 the ideal vocoder output IS this waveform).
    Returns (audio [total_frames*600], f0_2f [2*total_frames])."""
    from fluidaudio_tpu_torch.models.kokoro import HOP, SAMPLE_RATE

    f0_2f = np.zeros(2 * total_frames, np.float32)
    env = np.zeros(total_frames * HOP, np.float32)
    ramp = int(0.010 * SAMPLE_RATE)
    edge = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
    for k, w in enumerate(word_ids):
        start_f = TTS_PAD_FRAMES + k * (TTS_WORD_FRAMES + TTS_GAP_FRAMES)
        end_f = start_f + TTS_WORD_FRAMES
        if end_f > total_frames:
            break
        f0_2f[2 * start_f : 2 * end_f] = tc.word_freq(int(w))
        s, e = start_f * HOP, end_f * HOP
        env[s:e] = 0.35
        env[s : s + ramp] = 0.35 * edge
        env[e - ramp : e] = 0.35 * edge[::-1]
    phase = tts_source_phase(f0_2f, variant)[: env.size]
    return (env * np.sin(phase)).astype(np.float32), f0_2f


def _tiny_asr(device):
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.zoo import AsrModels

    return AsrManager(
        AsrModels.load("test-tiny", checkpoint_dir=trained_assets_dir() / "asr",
                       allow_random_init=False, device=device),
        ASRConfig(),
    )


# --------------------------------------------------------------- PocketTTS
#: roundtrip gate of the trained PocketTTS fixture (as for Kokoro's; the JAX
#: reference itself does not clear it, ROADMAP Queue C)
POCKET_ROUNDTRIP_WER_GATE = 0.02


def pocket_tiny_config():
    """The JAX package's tiny PocketTtsConfig of the trained `pocket`
    fixture: the full streaming topology (flow-LM with a KV cache over 512
    positions, 8-step Euler flow decoder, a Mimi codec whose hop is 600
    samples)."""
    from fluidaudio_tpu_torch.models.mimi import MimiConfig
    from fluidaudio_tpu_torch.models.pocket_tts import PocketTtsConfig

    mimi = MimiConfig(
        latent_dim=8, dim=32, n_filters=4, ratios=(5, 5, 4, 3), kernel=5,
        trans_layers=2, trans_heads=4, trans_ff=64, trans_context=16,
    )
    return PocketTtsConfig(
        vocab_size=128, d_model=64, n_layers=2, n_heads=4, ff_hidden=96,
        flow_blocks=2, flow_hidden=64, max_frames=160, mimi=mimi,
    )


def pocket_voice_reference() -> np.ndarray:
    """Deterministic 24 kHz voice-cloning sample (three tone words, ~1.3 s),
    the fixture's training prompt clip."""
    return tts_target_audio(np.asarray([2, 9, 14]), total_frames=52)


def load_pocket_manager(*, device=None):
    from fluidaudio_tpu_torch.tts.pocket_manager import PocketTtsManager

    return PocketTtsManager(config=pocket_tiny_config(),
                            checkpoint_dir=trained_assets_dir() / "pocket", device=device)


def eval_pocket_fixture(seed: int = 7531, n_utts: int = 3, *, device=None) -> dict:
    """The PocketTTS streaming-AR contract: text -> normalize/chunk -> char
    tokens -> KV prefill -> per-frame flow-LM step + EOS threshold -> Euler
    flow decode -> streaming Mimi decode, then CLOSED LOOP through the
    trained ASR fixture; also `clone_voice` from the reference clip. Each
    utterance's (text, transcript) under `"utterances"`."""
    from fluidaudio_tpu_torch.tts.roundtrip import TINY_CORPUS_CHANNEL, tts_asr_roundtrip

    tts = load_pocket_manager(device=device)
    asr = _tiny_asr(device)
    rs = np.random.RandomState(seed)
    rates, utterances = [], []
    for _ in range(n_utts):
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 7)))
        r = tts_asr_roundtrip(tts, asr, tc.transcript_text(ids), channel=TINY_CORPUS_CHANNEL)
        rates.append(r.wer)
        utterances.append((r.text, r.transcript))
    tts.clone_voice(pocket_voice_reference(), "cloned")
    r = tts_asr_roundtrip(tts, asr, tc.transcript_text(np.asarray([1, 8])), voice="cloned",
                          channel=TINY_CORPUS_CHANNEL)
    utterances.append((r.text, r.transcript))
    return {"roundtrip_wer_avg": float(np.mean(rates)), "clone_roundtrip_wer": float(r.wer),
            "utterances": utterances}


# -------------------------------------------------------------- StyleTTS2
#: roundtrip gate of the trained StyleTTS2 fixture
STYLETTS2_ROUNDTRIP_WER_GATE = 0.02


def styletts2_tiny_config():
    """The JAX package's tiny StyleTts2Config of the trained `styletts2`
    fixture: the full 4-program topology, vocab 178 (the real TextCleaner
    table), rates multiplying to 300 (HOP 600), f0_scale 500."""
    from fluidaudio_tpu_torch.models.styletts2 import StyleTts2Config

    return StyleTts2Config(
        d_model=64, style_dim=32, n_layer=1, max_dur=16,
        albert_emb=32, albert_hidden=64, albert_heads=4, albert_inter=128,
        albert_layers=2,
        style_dim_in=8, style_max_conv_dim=32,
        diff_width=64, diff_layers=2, diff_heads=4,
        decoder_hidden=64, asr_res_ch=16,
        upsample_initial=64, upsample_rates=(20, 15),
        upsample_kernels=(40, 31),
        resblock_kernels=(3, 7), resblock_dilations=((1, 3), (1, 3)),
        max_frames=256, max_tokens=64,
        f0_scale=500.0,
    )


def styletts2_ref_clip() -> np.ndarray:
    """Deterministic 24 kHz style-reference clip (three tone words, ~1.3 s),
    the fixture's training reference."""
    return tts_target_audio(np.asarray([2, 9, 14]), total_frames=52)


def load_styletts2_manager(*, device=None):
    from fluidaudio_tpu_torch.tts.styletts2_manager import StyleTTS2Manager

    mgr = StyleTTS2Manager(config=styletts2_tiny_config(),
                           checkpoint_dir=trained_assets_dir() / "styletts2", device=device)
    # tone words resolve through the custom-lexicon slot of the shared
    # English G2P cascade (the manager's phonemizer shares this instance)
    mgr.g2p.custom_lexicon = tts_lexicon()
    return mgr


def eval_styletts2_fixture(seed: int = 6174, n_utts: int = 3, *, device=None) -> dict:
    """The StyleTTS2 synthesis contract: text -> phonemizer -> TextCleaner
    ids -> text program -> ref-mel style encoders + ADPM2 style sampling ->
    blend -> duration rounding -> acoustic program -> 24 kHz audio, then
    CLOSED LOOP through the trained ASR fixture; the duration head's mean
    absolute error in frames; each utterance's (text, transcript) under
    `"utterances"`."""
    from fluidaudio_tpu_torch.models.styletts2 import blend_style, round_durations
    from fluidaudio_tpu_torch.tts.roundtrip import TINY_CORPUS_CHANNEL, tts_asr_roundtrip
    from fluidaudio_tpu_torch.tts.styletts2_manager import text_cleaner_encode

    tts = load_styletts2_manager(device=device)
    asr = _tiny_asr(device)
    ref = styletts2_ref_clip()
    rs = np.random.RandomState(seed)
    rates, dur_errs, utterances = [], [], []
    for u in range(n_utts):
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 8)))
        text = tc.transcript_text(ids)
        r = tts_asr_roundtrip(tts, asr, text, reference_audio=ref, noise_seed=u,
                              channel=TINY_CORPUS_CHANNEL)
        rates.append(r.wer)
        utterances.append((r.text, r.transcript))

        # duration head accuracy through the predict program, at JAX's
        # 64-token grid
        tok = text_cleaner_encode(tts.phonemizer.phonemize(text))
        tokens = np.zeros((1, 64), np.int64)
        tokens[0, : len(tok)] = tok
        lengths = torch.tensor([len(tok)], dtype=torch.int32, device=tts.device)
        bert_dur, d_en, _ = tts.text_prog(torch.as_tensor(tokens).to(tts.device), lengths)
        s_pred, ref_s = tts.styles(bert_dur, lengths, ref, u)
        _, s128 = blend_style(s_pred, ref_s)
        _, dur_logits = tts.predict_prog(d_en, torch.as_tensor(s128).to(tts.device), lengths)
        got = round_durations(dur_logits[0].cpu().numpy(), len(tok))
        want = np.concatenate([[TTS_PAD_FRAMES],
                               np.asarray([[TTS_WORD_FRAMES, TTS_GAP_FRAMES]
                                           for _ in ids]).reshape(-1)[:-1]])
        dur_errs.append(float(np.abs(got - want).mean()))
    return {"roundtrip_wer_avg": float(np.mean(rates)),
            "dur_mae_frames": float(np.mean(dur_errs)), "utterances": utterances}
