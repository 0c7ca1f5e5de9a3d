"""Deterministic synthetic ASR corpus of the trained `test-tiny` fixture.

The ASR slice of `fluidaudio_tpu/train/tiny_corpus.py`, copied as plain numpy
so that the port (and `chip_smoke.py`) can make the fixture's utterances
without importing JAX. It must stay bit-identical to the original:
`tests/test_torch_asr_manager.py` checks that.

The language has 16 words. Word `i` is a 0.30 s pure tone at
`240 * 1.21**i` Hz with a Hann onset/offset ramp; words are separated by
0.12 s silences. Token `i` is the SentencePiece-style piece `▁w{i}`, so a
decode reads "w3 w7 w1 ...". The multilingual Nemotron fixture adds a second
language, "b": word `i` is a fundamental at `200 * 1.17**i` Hz plus a strong
2.3x partial, read "v{i}".
"""

from __future__ import annotations

import numpy as np

SR = 16_000

N_WORDS = 16
WORD_SEC = 0.30
GAP_SEC = 0.12
VOCAB_SIZE = 64  # matches zoo "test-tiny" predictor vocab (blank id 64)


def word_freq(i: int) -> float:
    return 240.0 * (1.21**i)  # 240 Hz .. ~4.2 kHz, log-spaced


def word_text(i: int) -> str:
    return f"w{i}"


def tiny_vocab() -> dict[int, str]:
    """id -> piece map for the test-tiny zoo entry: words 0..15 then fillers
    (present so the vocab size matches the joint's 64 token logits)."""
    vocab = {i: "▁" + word_text(i) for i in range(N_WORDS)}
    for i in range(N_WORDS, VOCAB_SIZE):
        vocab[i] = f"▁unused{i}"
    return vocab


def word_audio(i: int, amp: float = 0.35) -> np.ndarray:
    n = int(WORD_SEC * SR)
    t = np.arange(n) / SR
    sig = np.sin(2 * np.pi * word_freq(i) * t)
    ramp = int(0.010 * SR)
    env = np.ones(n)
    env[:ramp] = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
    env[-ramp:] = env[:ramp][::-1]
    return (amp * env * sig).astype(np.float32)


def word_freq_b(i: int) -> float:
    """Language-B base frequency grid (offset from A's so neither language's
    fundamentals collide)."""
    return 200.0 * (1.17**i)  # 200 Hz .. ~2.1 kHz


def word_text_b(i: int) -> str:
    return f"v{i}"


def word_audio_b(i: int, amp: float = 0.35) -> np.ndarray:
    """Language-B word: fundamental + strong 2.3x partial, a harmonic timbre
    acoustically distinct from A's pure tones."""
    n = int(WORD_SEC * SR)
    t = np.arange(n) / SR
    f = word_freq_b(i)
    sig = 0.7 * np.sin(2 * np.pi * f * t) + 0.5 * np.sin(2 * np.pi * 2.3 * f * t)
    ramp = int(0.010 * SR)
    env = np.ones(n)
    env[:ramp] = 0.5 - 0.5 * np.cos(np.pi * np.arange(ramp) / ramp)
    env[-ramp:] = env[:ramp][::-1]
    return (amp * env * sig).astype(np.float32)


def make_utterance(
    word_ids: list[int] | np.ndarray,
    rs: np.random.RandomState | None = None,
    lead_sec: float = 0.10,
    noise: float = 0.002,
    lang: str = "a",
) -> np.ndarray:
    """Concatenate words with gaps; amplitude jitter + noise floor from `rs`.
    `lang` selects the word rendering ("a" pure tones / "b" harmonic)."""
    rs = rs or np.random.RandomState(0)
    render = word_audio if lang == "a" else word_audio_b
    parts = [np.zeros(int(lead_sec * SR), np.float32)]
    for w in word_ids:
        amp = float(rs.uniform(0.25, 0.45))
        parts.append(render(int(w), amp))
        parts.append(np.zeros(int(GAP_SEC * SR), np.float32))
    audio = np.concatenate(parts)
    if noise:
        audio = audio + rs.randn(audio.size).astype(np.float32) * noise
    return audio.astype(np.float32)


def transcript_text(word_ids) -> str:
    return " ".join(word_text(int(w)) for w in word_ids)
