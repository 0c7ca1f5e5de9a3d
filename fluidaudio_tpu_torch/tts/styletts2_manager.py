"""StyleTTS2Manager: reference-audio-styled TTS (LibriTTS iteration_3), in PyTorch.

Port of `fluidaudio_tpu/tts/styletts2_manager.py` (reference
`StyleTTS2/StyleTTS2Manager.swift:37` driving the 8-stage synthesizer,
`StyleTTS2Synthesizer.swift:33-133`): the TextCleaner symbol table, the
phonemizer, the reference-mel extractor (16 kHz filterbank on 24 kHz audio,
`styletts2_ref_mel`, numpy on the host) and the glue are copies of JAX's.

Per chunk on `device` (None = the GPU): the token ids go up padded to a
token bucket (64/128/256, then max_tokens), the text program runs; the
reference mel goes up padded to a mel bucket with the sampler's noise
(`noise_init`, `noises_aux`: numpy `RandomState(noise_seed)`, as in JAX, so
the draws are JAX's bit for bit) and the style program runs; the two style
vectors come back (one copy) for the host's alpha/beta blend; the predict
program runs and its duration logits come back (one copy) for the host's
rounding; the frame map goes up padded to a frame bucket, the acoustic
program runs (its harmonic source deterministic, as JAX's manager runs it)
and the samples come back (one copy).

Weights: `checkpoint_dir` holds `{text,style,predict,acoustic}.npz`;
`checkpoint_dir=None` reads the model cache's `Repo.STYLETTS2` folder, as
JAX does; without them the weights are seeded random, drawn on `device`.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from fluidaudio_tpu_torch.models.kokoro import expand_durations, random_init_kokoro_
from fluidaudio_tpu_torch.models.styletts2 import (
    DIFFUSION_STEPS,
    HOP,
    SAMPLE_RATE,
    STYLETTS2_BASE,
    StyleTts2AcousticProgram,
    StyleTts2Config,
    StyleTts2PredictProgram,
    StyleTts2StyleProgram,
    StyleTts2TextProgram,
    blend_style,
    round_durations,
)
from fluidaudio_tpu_torch.models.zoo import disable_tf32
from fluidaudio_tpu_torch.registry import DownloadUtils, Repo
from fluidaudio_tpu_torch.tts.g2p import EnglishG2P
from fluidaudio_tpu_torch.tts.phoneme_chunker import chunk_phonemes
from fluidaudio_tpu_torch.utils.device import resolve_device
from fluidaudio_tpu_torch.utils.logging import get_logger
from fluidaudio_tpu_torch.utils.weights import load_npz, load_state

logger = get_logger("tts.styletts2")

# --------------------------------------------------------------------------
# TextCleaner: pad + punctuation + letters + IPA, canonical training order
# (StyleTTS2TextCleaner.swift:13-48; later duplicates overwrite earlier ids)
# --------------------------------------------------------------------------

_PAD = "$"
_PUNCTUATION = ';:,.!?¡¿—…"«»“” '
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_IPA = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)
SYMBOLS = [_PAD] + list(_PUNCTUATION) + list(_LETTERS) + list(_IPA)
_CHAR_TO_ID = {c: i for i, c in enumerate(SYMBOLS)}  # last write wins


def text_cleaner_encode(phonemes: str, prepend_pad: bool = True) -> list[int]:
    """espeak-IPA string -> TextCleaner ids; unknown chars silently dropped
    (`StyleTTS2TextCleaner.encode`)."""
    ids = [0] if prepend_pad else []
    ids.extend(_CHAR_TO_ID[c] for c in phonemes if c in _CHAR_TO_ID)
    return ids


# --------------------------------------------------------------------------
# Phonemizer: shared English cascade + Misaki -> espeak shorthand expansion
# --------------------------------------------------------------------------

# Misaki/Kokoro single-char diphthong shorthand -> espeak two-char IPA
# (StyleTTS2Phonemizer.swift:172-189). StyleTTS2 was trained on espeak
# transcriptions; without expansion the TextCleaner reads `O` as the Latin
# letter and the audio is gibberish. Lowercase a/o/i/y/w are real IPA or
# grapheme passthrough and stay untouched.
MISAKI_SHORTHAND = {"A": "eɪ", "O": "oʊ", "I": "aɪ", "Y": "ɔɪ", "W": "aʊ"}

_PUNCT_SET = set(_PUNCTUATION)


def expand_misaki_shorthand(ipa: str) -> str:
    """Expand A/O/I/Y/W diphthong shorthand
    (`StyleTTS2Phonemizer.expandMisakiShorthand`)."""
    return "".join(MISAKI_SHORTHAND.get(c, c) for c in ipa)


class StyleTts2Phonemizer:
    """Text -> espeak-IPA string for the StyleTTS2 TextCleaner.

    Reference `StyleTTS2Phonemizer.swift:58-170`: conservative raw-text
    normalization, word split, TextCleaner-punctuation passthrough, the
    shared English lexicon/initialism cascade (via `EnglishG2P`), Misaki
    shorthand expansion on every resolved word, grapheme passthrough on a
    degraded G2P miss (never drop a word — that would shift alignment),
    and a hard error when nothing at all resolves.
    """

    def __init__(self, g2p: EnglishG2P | None = None):
        self.g2p = g2p or EnglishG2P()

    def phonemize(self, text: str) -> str:
        from fluidaudio_tpu_torch.tts.g2p import split_words
        from fluidaudio_tpu_torch.tts.text_normalizer import english_normalize

        trimmed = text.strip()
        if not trimmed:
            return ""
        normalized = english_normalize(trimmed)
        parts: list[str] = []
        any_resolved = False
        for word in split_words(normalized):
            if not word:
                continue
            if all(c in _PUNCT_SET for c in word):
                # TextCleaner has direct entries for these; counts as
                # resolved so punctuation-only input doesn't raise
                parts.append(word)
                any_resolved = True
                continue
            ipa = self.g2p.word_to_phonemes(word)
            if ipa:
                parts.append(expand_misaki_shorthand(ipa))
                any_resolved = True
            else:
                # degraded path: the symbol table has ASCII letters, so
                # graphemes still produce something alignment-preserving
                logger.info("G2P unresolved for %r; passing graphemes", word)
                parts.append(word)
        if not any_resolved:
            raise ValueError(
                f"phonemization failed: no words resolved (input={trimmed[:40]!r})"
            )
        return " ".join(parts)

    def encode(self, text: str) -> list[int]:
        """Text -> TextCleaner ids with the leading pad
        (`StyleTTS2Phonemizer.encode`)."""
        return text_cleaner_encode(self.phonemize(text))


# --------------------------------------------------------------------------
# reference-audio mel (torchaudio parity incl. the 16 kHz filterbank quirk)
# --------------------------------------------------------------------------

_MEL_SR_QUIRK = 16_000  # filterbank built at 16 kHz, audio is 24 kHz
_MEL_NFFT = 2_048
_MEL_WIN = 1_200
_MEL_HOP = 300


def _htk_filterbank(n_fft: int, n_mels: int, sr: int) -> np.ndarray:
    """torchaudio default melscale_fbanks: HTK scale, no norm."""
    f_max = sr / 2.0
    m_min, m_max = 0.0, 2595.0 * np.log10(1.0 + f_max / 700.0)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    fb = np.zeros((n_fft // 2 + 1, n_mels))
    for m in range(n_mels):
        lo, ctr, hi = f_pts[m], f_pts[m + 1], f_pts[m + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


_FB_CACHE: dict[int, np.ndarray] = {}


def styletts2_ref_mel(audio_24k: np.ndarray, n_mels: int = 80) -> np.ndarray:
    """24 kHz mono f32 -> normalized log-mel [n_mels, T] (torchaudio parity:
    reflect-pad center, periodic hann(1200), power 2, HTK filterbank built at
    16 kHz — the upstream `make_preprocess()` never overrides sample_rate)."""
    x = np.asarray(audio_24k, np.float32).reshape(-1)
    if n_mels not in _FB_CACHE:
        _FB_CACHE[n_mels] = _htk_filterbank(_MEL_NFFT, n_mels, _MEL_SR_QUIRK)
    pad = _MEL_NFFT // 2
    if x.size < 2:
        x = np.zeros(2, np.float32)
    xp = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (xp.size - _MEL_NFFT) // _MEL_HOP
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(_MEL_WIN) / _MEL_WIN)  # periodic
    wpad = (_MEL_NFFT - _MEL_WIN) // 2
    win_full = np.zeros(_MEL_NFFT, np.float32)
    win_full[wpad : wpad + _MEL_WIN] = win
    idx = np.arange(n_frames)[:, None] * _MEL_HOP + np.arange(_MEL_NFFT)[None, :]
    frames = xp[idx] * win_full[None, :]
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2  # [T, n_fft//2+1]
    mel = spec @ _FB_CACHE[n_mels]  # [T, n_mels]
    return ((np.log(mel + 1e-5) + 4.0) / 4.0).T.astype(np.float32)


# --------------------------------------------------------------------------


@dataclass
class StyleTts2Result:
    samples: np.ndarray
    sample_rate: int

    @property
    def duration(self) -> float:
        return self.samples.size / self.sample_rate


_TOKEN_BUCKETS = (64, 128, 256)  # StyleTTS2Constants.bucketTokenSizes
_MEL_BUCKETS = (128, 256, 512, 1024)


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def ref_mel_padded(reference_audio: np.ndarray | None,
                   n_mels: int) -> tuple[np.ndarray, int]:
    """Reference audio -> (bucket-padded mel [1, n_mels, mb], frames used).

    Single source of truth for the style-encoder input convention (the
    trained fixture computes its training-time reference style through this
    same helper, so train and inference cannot drift). None = the silence
    default (1 s of zeros). Padding REPLICATES the last frame: the style
    encoder's convs smear a few boundary columns of padding into the masked
    pool at every scale, and zero (nowhere near log-mel silence) shifts the
    style vector; an edge-continued signal keeps the bleed negligible."""
    if reference_audio is None:
        reference_audio = np.zeros(SAMPLE_RATE, np.float32)
    mel = styletts2_ref_mel(reference_audio, n_mels)
    frames = mel.shape[1]
    mb = _bucket(frames, _MEL_BUCKETS)
    used = min(frames, mb)
    mel_pad = np.repeat(mel[None, :, used - 1 : used], mb, axis=2).astype(np.float32)
    mel_pad[0, :, :used] = mel[:, :mb]
    return mel_pad, used


class StyleTTS2Manager:
    def __init__(
        self,
        config: StyleTts2Config | None = None,
        *,
        checkpoint_dir: str | Path | None = None,
        rng_seed: int = 0,
        device: torch.device | str | None = None,
    ):
        self.cfg = cfg = config or STYLETTS2_BASE
        self.device = dev = resolve_device(device)
        disable_tf32()
        self.text_prog = StyleTts2TextProgram(cfg, device=dev).eval()
        self.style_prog = StyleTts2StyleProgram(cfg, device=dev).eval()
        self.predict_prog = StyleTts2PredictProgram(cfg, device=dev).eval()
        self.acoustic_prog = StyleTts2AcousticProgram(cfg, deterministic=True, device=dev).eval()
        self.g2p = EnglishG2P()
        self.phonemizer = StyleTts2Phonemizer(self.g2p)

        gen = torch.Generator(device=dev).manual_seed(rng_seed)
        base = Path(checkpoint_dir) if checkpoint_dir else DownloadUtils.repo_dir(Repo.STYLETTS2)
        for part, program in (("text", self.text_prog), ("style", self.style_prog),
                              ("predict", self.predict_prog), ("acoustic", self.acoustic_prog)):
            random_init_kokoro_(program, gen)
            f = base / f"{part}.npz"
            if f.exists():
                load_state(program, load_npz(f))

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(self.device)

    # ------------------------------------------------------------------ api

    def synthesize(
        self,
        text: str,
        reference_audio: np.ndarray | None = None,
        *,
        alpha: float = 0.3,
        beta: float = 0.7,
        noise_seed: int = 0,
        speed: float = 1.0,
    ) -> StyleTts2Result:
        """Text -> 24 kHz samples. `alpha`/`beta` blend the diffusion-sampled
        style against the reference style (`StyleTTS2Synthesizer.swift:33-40`;
        defaults 0.3/0.7)."""
        cfg = self.cfg
        phonemes = self.phonemizer.phonemize(text)
        # chunk at max_tokens - 1 chars so pad + per-char tokens always fit
        # the largest bucket (StyleTTS2Constants.maxPhonemeChunkChars)
        pieces = chunk_phonemes(phonemes, cfg.max_tokens - 1)
        if len(pieces) > 1:
            outs = [
                self._synthesize_phonemes(
                    piece, reference_audio, alpha=alpha, beta=beta,
                    noise_seed=noise_seed + i, speed=speed,
                ).samples
                for i, piece in enumerate(pieces)
            ]
            return StyleTts2Result(
                samples=np.concatenate(outs) if outs else np.zeros(0, np.float32),
                sample_rate=SAMPLE_RATE,
            )
        return self._synthesize_phonemes(
            phonemes, reference_audio, alpha=alpha, beta=beta,
            noise_seed=noise_seed, speed=speed,
        )

    def token_bucket(self, n: int) -> int:
        cfg = self.cfg
        return _bucket(n, tuple(b for b in _TOKEN_BUCKETS if b < cfg.max_tokens) + (cfg.max_tokens,))

    def style_noise(self, noise_seed: int) -> tuple[np.ndarray, np.ndarray]:
        """The sampler's draws, JAX's: `noise_init` [1, 256] then
        `noises_aux` [4, 1, 256] from numpy `RandomState(noise_seed)`."""
        rng = np.random.RandomState(noise_seed)
        noise_init = rng.randn(1, 2 * self.cfg.style_dim).astype(np.float32)
        noises_aux = rng.randn(DIFFUSION_STEPS - 1, 1, 2 * self.cfg.style_dim).astype(np.float32)
        return noise_init, noises_aux

    def styles(self, bert_dur: torch.Tensor, lengths: torch.Tensor,
               reference_audio: np.ndarray | None, noise_seed: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """The style program on the reference mel and the seed's draws ->
        (s_pred, ref_s) [1, 256] on the host."""
        mel_pad, used = ref_mel_padded(reference_audio, self.cfg.n_mels)
        noise_init, noises_aux = self.style_noise(noise_seed)
        s_pred, ref_s = self.style_prog(
            self._tensor(mel_pad), self._tensor([used], torch.int32), bert_dur, lengths,
            self._tensor(noise_init), self._tensor(noises_aux))
        return s_pred.cpu().numpy(), ref_s.cpu().numpy()

    def _synthesize_phonemes(
        self,
        phonemes: str,
        reference_audio: np.ndarray | None = None,
        *,
        alpha: float = 0.3,
        beta: float = 0.7,
        noise_seed: int = 0,
        speed: float = 1.0,
    ) -> StyleTts2Result:
        cfg = self.cfg
        ids = text_cleaner_encode(phonemes)[: cfg.max_tokens]
        n = len(ids)
        tokens = np.zeros((1, self.token_bucket(n)), np.int64)
        tokens[0, :n] = ids
        lengths = self._tensor([n], torch.int32)
        bert_dur, d_en, t_en = self.text_prog(self._tensor(tokens), lengths)

        # style: ref_encoder + ADPM2 diffusion sampling
        s_pred, ref_s = self.styles(bert_dur, lengths, reference_audio, noise_seed)
        ref128, s128 = blend_style(s_pred, ref_s, alpha, beta)
        s128_t = self._tensor(s128.astype(np.float32))

        d, dur_logits = self.predict_prog(d_en, s128_t, lengths)
        durations = round_durations(dur_logits[0].cpu().numpy(), n).astype(np.float64)
        durations = np.maximum(np.rint(durations / max(speed, 0.05)), 1)
        frame_idx, total = expand_durations(durations, cfg.max_frames)
        fbkt = _bucket(total, tuple(b for b in (256, 512, 1024, 2048) if b < cfg.max_frames)
                       + (cfg.max_frames,))
        audio = self.acoustic_prog(
            d, t_en, self._tensor(frame_idx[:fbkt][None]), self._tensor([total], torch.int32),
            s128_t, self._tensor(ref128.astype(np.float32)))
        samples = audio[0].cpu().numpy()[: total * HOP + 1]
        trim = min(50, samples.size)  # tail trim (Synthesizer.swift:127-131)
        return StyleTts2Result(samples=samples[: samples.size - trim],
                               sample_rate=SAMPLE_RATE)
