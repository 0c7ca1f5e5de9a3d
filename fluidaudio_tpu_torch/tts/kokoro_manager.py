"""KokoroManager: parallel TTS public API over the Kokoro-82M graph, in PyTorch.

Port of `fluidaudio_tpu/tts/kokoro_manager.py` (reference
`KokoroAne/KokoroAneManager.swift:1-110` +
`Pipeline/KokoroAneSynthesizer.swift:17-160`): text -> phonemizer -> vocab
encode (178-symbol StyleTTS2 IPA table, ids wrapped [0, *ids, 0]) ->
voice-pack style row by phoneme count (style_timbre = ref[:128] feeds the
decoder/vocoder, style_s = ref[128:] the duration/prosody stages) -> the
text program and the audio program -> 24 kHz samples; <=512 IPA tokens per
call with auto-chunking; per-stage timings (`KokoroStageTimings`).

Per chunk: the token ids go to the device padded to a token bucket
(64/128/256/512), the text program runs, the durations come back (one
copy), `expand_durations` rounds them on the host, the frame map goes to the
device padded to a frame bucket, the audio program runs and the samples come
back (one copy). The harmonic source's noise comes from a `torch.Generator`
seeded to `rng_seed + 1` afresh for every chunk, as JAX uses one key for
every chunk of every call, so two calls on one text give the same samples.
The peak normalisation runs once over the whole concatenation.

Variants: `english` (Misaki lexicon + the BART fallback when cached),
`mandarin` (Hanzi through `MandarinG2P` to bopomofo, with the g2pW BERT
polyphone classifier on `device` when cached; phoneme strings pass through)
and `japanese` (phoneme input only, no peak normalisation).

Weights: `checkpoint_dir` holds `text.npz`, `audio.npz` and the voices;
`checkpoint_dir=None` reads the model cache's `Repo.KOKORO_ANE*` folder, as
JAX does; with no checkpoint the weights are seeded random, drawn on
`device`, and the seeded fallback voices stand in. `device=None` is the GPU;
pass "cpu" to run on the CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from fluidaudio_tpu_torch.models.kokoro import (
    HOP,
    MAX_TOKENS,
    SAMPLE_RATE,
    STYLE_DIM,
    KokoroAudioProgram,
    KokoroConfig,
    KokoroTextProgram,
    expand_durations,
    random_init_kokoro_,
)
from fluidaudio_tpu_torch.models.zoo import disable_tf32
from fluidaudio_tpu_torch.registry import DownloadUtils, Repo
from fluidaudio_tpu_torch.tts.audio_post import AudioPostProcessor
from fluidaudio_tpu_torch.tts.g2p import EnglishG2P, load_bart_fallback
from fluidaudio_tpu_torch.tts.phoneme_chunker import chunk_phonemes
from fluidaudio_tpu_torch.utils.device import resolve_device
from fluidaudio_tpu_torch.utils.logging import get_logger
from fluidaudio_tpu_torch.utils.weights import load_npz, load_state

logger = get_logger("tts.kokoro")

# StyleTTS2/Kokoro 178-symbol table: pad + punctuation + letters + IPA.
_PAD = "$"
_PUNCT = ';:,.!?¡¿—…"«»“” '
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_LETTERS_IPA = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)
SYMBOLS = [_PAD] + list(_PUNCT) + list(_LETTERS) + list(_LETTERS_IPA)
VOCAB = {s: i for i, s in enumerate(SYMBOLS)}

# voice packs index style rows by phoneme count: ref_s = pack[len(ps) - 1]
VOICE_PACK_ROWS = 510
VOICE_PACK_COLS = 256  # [timbre | prosody] halves of 128


class InvalidVoicePackError(ValueError):
    """Malformed voice-pack payload (`KokoroAneError.invalidVoicePack`)."""


def load_voice_pack(path) -> np.ndarray:
    """Load a flat fp32 `<voice>.bin` into [510, 256]
    (`KokoroAneVoicePack.load`): missing file -> FileNotFoundError; a byte
    count not divisible by 4 or an element count != 510*256 -> typed error."""
    from pathlib import Path as _Path

    p = _Path(path)
    if not p.exists():
        raise FileNotFoundError(f"voice pack missing: {p}")
    data = p.read_bytes()
    if len(data) % 4 != 0:
        raise InvalidVoicePackError(
            f"file size {len(data)} is not a multiple of sizeof(float32)=4"
        )
    storage = np.frombuffer(data, dtype="<f4")
    expected = VOICE_PACK_ROWS * VOICE_PACK_COLS
    if storage.size != expected:
        raise InvalidVoicePackError(
            f"expected {expected} fp32 elements, got {storage.size}"
        )
    return storage.reshape(VOICE_PACK_ROWS, VOICE_PACK_COLS).copy()


def slice_voice_pack(pack: np.ndarray, phoneme_count: int) -> tuple[np.ndarray, np.ndarray]:
    """Row for the phoneme-length bucket, clamped into [0, 509]; returns
    (style_s, style_timbre), the [128:256] and [0:128] column halves
    (`KokoroAneVoicePack.slice`)."""
    row = max(min(phoneme_count - 1, pack.shape[0] - 1), 0)
    half = pack.shape[1] // 2
    return pack[row, half:], pack[row, :half]

# Variant contract (reference KokoroAneConstants.swift:131-163): per-variant
# HF repo, default voice, and text frontend. `mandarin` routes Hanzi through
# MandarinG2P -> bopomofo; `japanese` ships no text frontend (phoneme input
# only) and writes audio at native level (no peak normalization,
# KokoroAneManager.swift:380-387).
VARIANTS = ("english", "mandarin", "japanese")
_VARIANT_REPO = {
    "english": Repo.KOKORO_ANE,
    "mandarin": Repo.KOKORO_ANE_ZH,
    "japanese": Repo.KOKORO_ANE_JA,
}
_VARIANT_DEFAULT_VOICE = {
    "english": "af_heart",
    "mandarin": "zf_001",
    "japanese": "jf_alpha",
}


def _seed_zh_vocab() -> dict[str, int]:
    """Built-in stand-in for `ANE-zh/vocab.json` (bopomofo initials/finals,
    special hanzi finals, tone digits, punctuation). A real vocab.json in
    the asset cache always takes precedence."""
    from fluidaudio_tpu_torch.tts.mandarin_g2p import (
        _FINAL_MAP,
        _INITIAL_MAP,
        ALLOWED_PUNCTUATION,
    )

    symbols = [_PAD] + sorted(ALLOWED_PUNCTUATION) + list("12345")
    symbols += list(dict.fromkeys(_INITIAL_MAP.values()))
    symbols += list(dict.fromkeys(_FINAL_MAP.values()))
    return {s: i for i, s in enumerate(symbols)}


@dataclass
class KokoroStageTimings:
    g2p_seconds: float = 0.0
    text_seconds: float = 0.0
    audio_seconds: float = 0.0
    post_seconds: float = 0.0


@dataclass
class KokoroSynthesisResult:
    samples: np.ndarray  # f32 @ 24 kHz
    sample_rate: int
    timings: KokoroStageTimings = field(default_factory=KokoroStageTimings)
    # False for the japanese variant: output stays at the model's native
    # level instead of being peak-scaled to 0 dBFS (ref KokoroAneManager
    # wavData(from:), issue #698)
    peak_normalized: bool = True

    @property
    def duration(self) -> float:
        return self.samples.size / self.sample_rate


class KokoroManager:
    def __init__(
        self,
        *,
        variant: str = "english",
        default_voice: str | None = None,
        checkpoint_dir: str | Path | None = None,
        rng_seed: int = 0,
        speed: float = 1.0,
        config: KokoroConfig | None = None,
        device: torch.device | str | None = None,
    ):
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
        self.variant = variant
        self.default_voice = default_voice or _VARIANT_DEFAULT_VOICE[variant]
        self.cfg = config or KokoroConfig()
        self.speed = speed
        self.rng_seed = rng_seed
        self.device = resolve_device(device)
        disable_tf32()
        lex_base = (
            Path(checkpoint_dir)
            if checkpoint_dir
            else DownloadUtils.repo_dir(_VARIANT_REPO[variant])
        )
        self.g2p = None
        self.mandarin_g2p = None
        self.vocab = dict(VOCAB)
        if variant == "english":
            # full Misaki lexicon + converted BART fallback when the kokoro
            # asset cache holds them (us_lexicon_cache.json / bart.npz —
            # reference LexiconAssetCache.swift:35, G2PModel.swift:6)
            self.g2p = EnglishG2P(fallback=load_bart_fallback(lex_base, device=self.device))
            if self.g2p.load_misaki_cache(lex_base):
                logger.info("loaded Misaki lexicon cache (%d entries)",
                            len(self.g2p.misaki_lower))
        elif variant == "mandarin":
            from fluidaudio_tpu_torch.tts.mandarin_g2p import (
                MandarinG2P,
                MandarinG2pw,
                MandarinJiebaHmm,
            )

            g2pw = (MandarinG2pw.load(lex_base / "g2pw", device=self.device)
                    or MandarinG2pw.load(lex_base, device=self.device))
            self.mandarin_g2p = MandarinG2P(
                lexicon_path=lex_base / "mandarin_lexicon.json", g2pw=g2pw,
                jieba_hmm=MandarinJiebaHmm.load(lex_base / "jieba_hmm.json"),
            )
            self.vocab = self._load_vocab(lex_base) or _seed_zh_vocab()
        else:  # japanese: phoneme input only, IPA vocab like english
            self.vocab = self._load_vocab(lex_base) or dict(VOCAB)
        if config is None and self.vocab:
            import dataclasses

            need = max(self.vocab.values()) + 1
            if need > self.cfg.vocab_size:
                self.cfg = dataclasses.replace(self.cfg, vocab_size=need)
        self.text_program = KokoroTextProgram(self.cfg, device=self.device).eval()
        self.audio_program = KokoroAudioProgram(self.cfg, device=self.device).eval()
        self.post = AudioPostProcessor(SAMPLE_RATE)

        gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        random_init_kokoro_(self.text_program, gen)
        random_init_kokoro_(self.audio_program, gen)
        self.has_real_weights = False
        for part, program in (("text", self.text_program), ("audio", self.audio_program)):
            f = lex_base / f"{part}.npz"
            if f.exists():
                load_state(program, load_npz(f))
                self.has_real_weights = True
        self.voices = self._load_voices(lex_base)

    def _load_vocab(self, base: Path) -> dict[str, int] | None:
        """Per-variant `vocab.json` from the asset bundle ({symbol: id},
        reference KokoroAneVocab); None when not cached."""
        f = base / "vocab.json"
        if not f.exists():
            return None
        import json

        payload = json.loads(f.read_text(encoding="utf-8"))
        return {str(k): int(v) for k, v in payload.items()}

    # seeded fallback voices per variant (real packs come from voices.npz)
    _FALLBACK_VOICES = {
        "english": ("af_heart", "af_bella", "am_adam"),
        "mandarin": ("zf_001", "zm_010"),
        "japanese": ("jf_alpha", "jm_kumo"),
    }

    def _load_voices(self, base: Path) -> dict[str, np.ndarray]:
        """Voice packs: [510, 256] style rows indexed by phoneme count
        (reference VoicePack; upstream packs are [510, 1, 256]). Mandarin/
        Japanese bundles keep packs under voices/ (useVoicesSubdir,
        KokoroAneConstants.swift:148-153) — the converter flattens them
        into one voices.npz either way."""
        for f in (base / "voices.npz", base / "voices" / "voices.npz"):
            if f.exists():
                data = np.load(f)
                return {k: data[k].reshape(-1, STYLE_DIM) for k in data.files}
        # release layout: one flat fp32 `<voice>.bin` per voice
        # (KokoroAneVoicePack.load), at the repo root or under voices/
        for d in (base / "voices", base):
            if d.is_dir():
                packs = {p.stem: p for p in sorted(d.glob("*.bin"))}
                if packs:
                    return {name: load_voice_pack(p) for name, p in packs.items()}
        rng = np.random.RandomState(7)
        return {
            name: rng.randn(VOICE_PACK_ROWS, STYLE_DIM).astype(np.float32) * 0.1
            for name in self._FALLBACK_VOICES[self.variant]
        }

    @property
    def available_voices(self) -> list[str]:
        return sorted(self.voices)

    def encode_phonemes(self, phonemes: str) -> list[int]:
        ids = [self.vocab[c] for c in phonemes if c in self.vocab]
        return ids[: MAX_TOKENS - 2]

    def set_english_custom_lexicon(self, entries: dict[str, str]) -> None:
        """User word -> Misaki-IPA overrides, checked before the bundled
        lexicon (ref KokoroAneManager.setEnglishCustomLexicon). Only
        meaningful for the english variant; a no-op store otherwise."""
        if self.g2p is not None:
            self.g2p.custom_lexicon = dict(entries)

    def set_mandarin_custom_lexicon(self, entries: dict[str, list[str]]) -> None:
        """User word -> pinyin/@bopomofo token overrides, slotted at the
        front of the MandarinG2P cascade (ref setMandarinCustomLexicon).
        Only meaningful for the mandarin variant."""
        if self.mandarin_g2p is not None:
            self.mandarin_g2p.set_custom_lexicon(entries)

    def phonemes_for(self, text: str) -> str:
        """Resolve the exact phoneme string `synthesize` would feed the
        chain (reference `phonemes(for:)`, KokoroAneManager.swift:237-261).

        English: Misaki-lexicon-first with BART fallback. Mandarin: the
        MandarinG2P bopomofo pipeline for Hanzi input, pass-through for
        strings already in phoneme form. Japanese: no text frontend —
        raises; feed pre-computed IPA via `synthesize_from_phonemes`."""
        if self.variant == "english":
            return self.g2p.phonemize(text)
        if self.variant == "mandarin":
            from fluidaudio_tpu_torch.tts.mandarin_g2p import MandarinG2P

            if MandarinG2P.looks_like_hanzi(text):
                return self.mandarin_g2p.phonemize_bopomofo(text)
            # no Hanzi -> caller already supplied bopomofo; pass through so
            # power users can override pronunciation manually
            return text
        raise ValueError(
            "japanese variant has no text G2P frontend; call "
            "synthesize_from_phonemes() with pre-computed IPA"
        )

    def synthesize(self, text: str, voice: str | None = None) -> KokoroSynthesisResult:
        timings = KokoroStageTimings()
        t0 = time.perf_counter()
        phonemes = self.phonemes_for(text)
        timings.g2p_seconds = time.perf_counter() - t0
        return self._synthesize_resolved(phonemes, voice, timings)

    def synthesize_from_phonemes(
        self, phonemes: str, voice: str | None = None
    ) -> KokoroSynthesisResult:
        """Bypass G2P; feed an already-resolved phoneme string. Strict:
        raises past the 510-token cap instead of auto-chunking (reference
        synthesizeFromPhonemes contract)."""
        n = sum(1 for c in phonemes if c in self.vocab)
        if n > MAX_TOKENS - 2:
            raise ValueError(
                f"phoneme sequence too long: {n} > {MAX_TOKENS - 2} tokens"
            )
        return self._synthesize_resolved(phonemes, voice, KokoroStageTimings())

    def _synthesize_resolved(
        self, phonemes: str, voice: str | None, timings: KokoroStageTimings
    ) -> KokoroSynthesisResult:
        voice = voice or self.default_voice
        pieces = [self._synthesize_chunk(chunk, voice, timings)
                  for chunk in chunk_phonemes(phonemes, MAX_TOKENS - 2)]
        t0 = time.perf_counter()
        audio = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
        audio = self.post.process(audio)
        # Peak-scale once over the full concatenation so levels stay
        # consistent across chunk joins; japanese writes at the model's
        # native level (ref KokoroAneManager wavData(from:))
        normalize = self.variant != "japanese"
        if normalize and audio.size:
            peak = float(np.abs(audio).max())
            if peak > 0:
                audio = audio / peak
        timings.post_seconds = time.perf_counter() - t0
        return KokoroSynthesisResult(
            samples=audio,
            sample_rate=SAMPLE_RATE,
            timings=timings,
            peak_normalized=normalize,
        )

    # static shape buckets: token count and frame count round up to these
    # (the reference's enumerated CoreML shapes; JAX's jit cache)
    _TOKEN_BUCKETS = (64, 128, 256, MAX_TOKENS)

    def _bucket(self, n: int, buckets) -> int:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    def frame_buckets(self) -> tuple[int, ...]:
        max_f = self.cfg.max_frames
        return self.cfg.frame_buckets or tuple(max_f // 8 * k for k in (1, 2, 4, 8))

    def style_for(self, phonemes: str, voice: str) -> tuple[torch.Tensor, torch.Tensor]:
        """(style_s, style_timbre) [1, style_dim] on the device: the voice
        pack's row for the raw phoneme-string length (BOS/EOS not counted),
        clamped into [0, 509] (reference KokoroAneVoicePack.slice)."""
        pack = self.voices.get(voice)
        if pack is None:
            raise KeyError(f"unknown voice {voice!r}; available: {self.available_voices}")
        sd = self.cfg.style_dim
        s_half, t_half = slice_voice_pack(pack, len(phonemes))
        as_row = lambda v: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(v[None, :sd], np.float32)).to(self.device)
        return as_row(s_half), as_row(t_half)

    def text_durations(self, ids: list[int], style_s: torch.Tensor
                       ) -> tuple[np.ndarray, torch.Tensor, torch.Tensor]:
        """Wrapped ids [0, *ids, 0] padded to a token bucket -> the text
        program -> (durations [n] on the host, before rounding; d and t_en
        on the device)."""
        wrapped = [0, *ids, 0]  # kokoro pads both ends with symbol 0 ('$')
        n = len(wrapped)
        tokens = np.zeros((1, self._bucket(n, self._TOKEN_BUCKETS)), np.int64)
        tokens[0, :n] = wrapped
        duration, d, t_en = self.text_program(
            torch.as_tensor(tokens).to(self.device),
            torch.tensor([n], dtype=torch.int32, device=self.device),
            style_s, self.speed)
        return duration[0, :n].cpu().numpy(), d, t_en

    def audio_for(self, d: torch.Tensor, t_en: torch.Tensor, durations: np.ndarray,
                  style_s: torch.Tensor, style_timbre: torch.Tensor) -> torch.Tensor:
        """Host-rounded durations -> frame map padded to a frame bucket -> the
        audio program (noise from a generator seeded to rng_seed + 1) ->
        samples [total_frames * HOP] on the device."""
        frame_idx, total_frames = expand_durations(durations, self.cfg.max_frames)
        bf = self._bucket(total_frames, self.frame_buckets())
        gen = torch.Generator(device=self.device).manual_seed(self.rng_seed + 1)
        audio = self.audio_program(
            d, t_en, torch.as_tensor(frame_idx[None, :bf].astype(np.int64)).to(self.device),
            torch.tensor([total_frames], dtype=torch.int32, device=self.device),
            style_s, style_timbre, generator=gen)
        return audio[0, : total_frames * HOP]

    def _synthesize_chunk(
        self, phonemes: str, voice: str, timings: KokoroStageTimings
    ) -> np.ndarray:
        ids = self.encode_phonemes(phonemes)
        if not ids:
            return np.zeros(0, np.float32)
        style_s, style_timbre = self.style_for(phonemes, voice)
        t0 = time.perf_counter()
        durations, d, t_en = self.text_durations(ids, style_s)
        timings.text_seconds += time.perf_counter() - t0
        t0 = time.perf_counter()
        out = self.audio_for(d, t_en, durations, style_s, style_timbre).cpu().numpy()
        timings.audio_seconds += time.perf_counter() - t0
        return out
