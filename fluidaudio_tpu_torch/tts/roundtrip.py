"""TTS -> ASR round-trip verification harness.

Behavioral parity: reference `tts-asr-verify` CLI command +
`KokoroAneAsrRoundtripTests` (SURVEY §4.6): synthesize text, transcribe it
with ASR, score WER between the input text and the transcript — a
model-level consistency check that works identically on TPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fluidaudio_tpu_torch.metrics import normalize_for_scoring, wer
from fluidaudio_tpu_torch.utils.converter import resample


@dataclass
class RoundTripResult:
    text: str
    transcript: str
    wer: float
    audio_seconds: float


@dataclass(frozen=True)
class AsrChannel:
    """Acoustic presentation of the synthesized audio to the verifying ASR.

    The reference's `tts-asr-verify` feeds Kokoro output straight into a
    production Parakeet, which is robust to playback level, lead-in and
    silence floor by virtue of large-scale training. The hermetic fixture
    tier verifies with a TINY ASR trained only on the constructed corpus
    (`tiny_corpus.make_utterance`: 0.10 s lead-in, trailing word gap,
    0.25-0.45 amplitude, 0.002 noise floor) — a narrow-domain model. This
    channel presents synthesized audio inside that domain (lead/tail
    silence, gain, dither at the corpus noise floor) so the closed loop
    measures SYNTHESIS quality, not the tiny ASR's out-of-domain behavior
    on digitally-silent, peak-normalized input. Intelligibility is still
    fully load-bearing: wrong tones, durations or spurious energy fail the
    gate regardless of channel. Default = identity (production behavior)."""

    lead_seconds: float = 0.0
    tail_seconds: float = 0.0
    gain: float = 1.0
    dither: float = 0.0
    seed: int = 0

    def apply(self, audio16k: np.ndarray) -> np.ndarray:
        out = audio16k * np.float32(self.gain)
        if self.lead_seconds or self.tail_seconds:
            out = np.concatenate([
                np.zeros(int(self.lead_seconds * 16_000), np.float32),
                out,
                np.zeros(int(self.tail_seconds * 16_000), np.float32),
            ])
        if self.dither:
            rs = np.random.RandomState(self.seed)
            out = out + rs.randn(out.size).astype(np.float32) * self.dither
        return out.astype(np.float32)


#: The tiny-fixture corpus domain (see AsrChannel docstring).
TINY_CORPUS_CHANNEL = AsrChannel(
    lead_seconds=0.10, tail_seconds=0.12, gain=0.35, dither=0.002)


def tts_asr_roundtrip(
    tts_manager, asr_manager, text: str,
    channel: AsrChannel | None = None,
    **tts_kwargs,
) -> RoundTripResult:
    """Synthesize `text` with `tts_manager`, transcribe with `asr_manager`,
    return the WER between normalized input and transcript."""
    synth = tts_manager.synthesize(text, **tts_kwargs)
    samples = np.asarray(synth.samples, np.float32)
    sr = getattr(synth, "sample_rate", 24_000)
    audio16k = resample(samples, sr, 16_000)
    if channel is not None:
        audio16k = channel.apply(audio16k)
    result = asr_manager.transcribe(audio16k)
    ref = normalize_for_scoring(text)
    hyp = normalize_for_scoring(result.text)
    breakdown = wer(ref, hyp)
    return RoundTripResult(
        text=text,
        transcript=result.text,
        wer=breakdown.rate,
        audio_seconds=samples.size / sr,
    )
