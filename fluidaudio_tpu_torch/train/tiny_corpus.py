"""Deterministic synthetic corpora of the trained tiny fixtures.

`fluidaudio_tpu/train/tiny_corpus.py` copied as plain numpy, so that the
port (and `chip_smoke.py`) can make the fixtures' utterances and training
batches (`asr_batch`, `vad_batch`, `sortformer_batch`, `lseend_batch`)
without importing JAX. It must stay bit-identical to the original for the
same `np.random.RandomState` seeds: `tests/test_torch_asr_manager.py` and
`tests/test_torch_train.py` check that.

The language has 16 words. Word `i` is a 0.30 s pure tone at
`240 * 1.21**i` Hz with a Hann onset/offset ramp; words are separated by
0.12 s silences. Token `i` is the SentencePiece-style piece `▁w{i}`, so a
decode reads "w3 w7 w1 ...". The multilingual Nemotron fixture adds a second
language, "b": word `i` is a fundamental at `200 * 1.17**i` Hz plus a strong
2.3x partial, read "v{i}". The VAD fixture's speech is `speechish`,
AM-modulated noise. The diarizer fixtures (`offline`, `sortformer`) hear
two "speakers", each a 3-partial harmonic stack with its own amplitude
modulation, mixed by `diarizer_mixture` into turns with reference segments;
`lseend_batch` resamples such mixtures to LS-EEND's 8 kHz with frame labels.
"""

from __future__ import annotations

import json
from pathlib import Path

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


def write_vocab_json(path: str | Path) -> None:
    Path(path).write_text(
        json.dumps({str(i): p for i, p in sorted(tiny_vocab().items())},
                   ensure_ascii=False)
    )


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


def asr_batch(
    rs: np.random.RandomState,
    batch: int,
    window_samples: int,
    min_words: int = 2,
    max_words: int = 33,
    u_max: int = 36,
) -> dict[str, np.ndarray]:
    """One training batch: utterances padded into a fixed window.

    Returns audio [B, W] f32, audio_lengths [B], labels [B, u_max] (padded
    with 0s), label_lengths [B]."""
    audio = np.zeros((batch, window_samples), np.float32)
    lengths = np.zeros((batch,), np.int32)
    labels = np.zeros((batch, u_max), np.int32)
    label_lengths = np.zeros((batch,), np.int32)
    for b in range(batch):
        n = int(rs.randint(min_words, max_words + 1))
        ids = rs.randint(0, N_WORDS, size=n)
        utt = make_utterance(ids, rs)
        if utt.size > window_samples:  # safety: trim trailing silence/words
            # drop words until it fits
            while utt.size > window_samples and n > 1:
                n -= 1
                ids = ids[:n]
                utt = make_utterance(ids, np.random.RandomState(rs.randint(1 << 30)))
            utt = utt[:window_samples]
        audio[b, : utt.size] = utt
        lengths[b] = utt.size
        labels[b, :n] = ids
        label_lengths[b] = n
    return {
        "audio": audio,
        "audio_lengths": lengths,
        "labels": labels,
        "label_lengths": label_lengths,
    }


# --------------------------------------------------------------------- VAD

VAD_FRAME = 512  # 32 ms model frames
VAD_CONTEXT = 64


def speechish(seconds: float, rs: np.random.RandomState) -> np.ndarray:
    """AM-modulated noise with syllabic (3 Hz) + phrasal (0.31 Hz) structure —
    the same character as the guardrail battery's synthetic speech."""
    t = np.arange(int(seconds * SR)) / SR
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t)) * (
        0.3 + 0.7 * (np.sin(2 * np.pi * 0.31 * t) > 0)
    )
    return (rs.randn(t.size) * 0.1 * (0.05 + env)).astype(np.float32)


def vad_example(
    rs: np.random.RandomState, n_frames: int
) -> tuple[np.ndarray, np.ndarray]:
    """(audio [CONTEXT + n_frames*512], frame labels [n_frames]).

    Audio is a random alternation of speech spans (speechish or tone words)
    and nonspeech spans (noise at varied level / near-silence); each 32 ms
    frame is labeled 1 iff >=50% of its fresh samples overlap a speech span."""
    total = n_frames * VAD_FRAME
    audio = np.zeros(total, np.float32)
    speech_mask = np.zeros(total, bool)
    pos = 0
    while pos < total:
        span = int(rs.uniform(0.25, 1.6) * SR)
        span = min(span, total - pos)
        if rs.rand() < 0.5:  # speech span
            kind = rs.rand()
            if kind < 0.5:
                # int(span/SR * SR) can round down to span-1: pad back below
                seg = speechish(span / SR, rs)[:span]
            else:
                ids = rs.randint(0, N_WORDS, size=max(1, span // int(0.42 * SR)))
                seg = make_utterance(ids, rs, lead_sec=0.02, noise=0.0)[:span]
            if seg.size < span:
                seg = np.pad(seg, (0, span - seg.size))
            audio[pos : pos + span] = seg
            # only the region that actually carries energy counts as speech.
            # NB: mode="same" returns max(len(seg), 256) samples, so a tail
            # span shorter than the RMS window must be truncated back.
            rms = np.sqrt(np.convolve(seg.astype(np.float64) ** 2,
                                      np.ones(256) / 256, mode="same"))[:span]
            speech_mask[pos : pos + span] = rms > 0.01
        else:  # nonspeech span
            level = float(10 ** rs.uniform(-3.3, -2.0))  # 0.0005 .. 0.01
            audio[pos : pos + span] = rs.randn(span).astype(np.float32) * level
        pos += span
    frames = speech_mask.reshape(n_frames, VAD_FRAME)
    labels = (frames.mean(axis=1) >= 0.5).astype(np.float32)
    full = np.concatenate([np.zeros(VAD_CONTEXT, np.float32), audio])
    return full, labels


def vad_batch(
    rs: np.random.RandomState, batch: int, n_frames: int
) -> tuple[np.ndarray, np.ndarray]:
    audio = np.zeros((batch, VAD_CONTEXT + n_frames * VAD_FRAME), np.float32)
    labels = np.zeros((batch, n_frames), np.float32)
    for b in range(batch):
        audio[b], labels[b] = vad_example(rs, n_frames)
    return audio, labels


# ----------------------------------------------------------------- diarizer

SPEAKER_STACKS = (
    (300.0, 450.0, 620.0),  # "speaker A": low harmonic stack
    (1800.0, 2300.0, 2900.0),  # "speaker B": high harmonic stack
)


def speaker_wave(k: int, seconds: float, rs: np.random.RandomState) -> np.ndarray:
    t = np.arange(int(seconds * SR)) / SR
    sig = np.zeros(t.size)
    for f in SPEAKER_STACKS[k]:
        sig += np.sin(2 * np.pi * f * t + rs.uniform(0, 2 * np.pi))
    am = 0.6 + 0.4 * np.sin(2 * np.pi * (3.1 if k == 0 else 2.3) * t
                            + rs.uniform(0, 2 * np.pi))
    return (0.18 * am * sig).astype(np.float32)


def diarizer_mixture(
    rs: np.random.RandomState,
    seconds: float,
    overlap_prob: float = 0.0,
    frame_sec: float = 0.08,
) -> tuple[np.ndarray, list[tuple[str, float, float]], np.ndarray]:
    """2-speaker mixture.

    Returns (mix [seconds*SR], ref segments [(speaker, start, end)...],
    arrival-order frame labels [T, 4]) where T = seconds/frame_sec and
    slot 0 is the first speaker to speak."""
    total = int(seconds * SR)
    mix = rs.randn(total).astype(np.float32) * 0.002
    segs: list[tuple[int, float, float]] = []
    pos = float(rs.uniform(0.2, 1.0))
    spk = int(rs.randint(0, 2))
    while pos < seconds - 2.0:
        dur = float(rs.uniform(2.0, 6.0))
        dur = min(dur, seconds - pos - 0.2)
        s0, s1 = int(pos * SR), int(pos * SR) + int(dur * SR)
        wave = speaker_wave(spk, dur, rs)
        mix[s0 : s0 + wave.size] += wave[: total - s0]
        segs.append((spk, pos, pos + dur))
        gap = float(rs.uniform(0.4, 1.2))
        if rs.rand() < overlap_prob:
            gap = -float(rs.uniform(0.3, 1.0))  # next segment overlaps tail
        pos = pos + dur + gap
        spk = 1 - spk
    # arrival-order slot mapping
    order: list[int] = []
    for k, _, _ in segs:
        if k not in order:
            order.append(k)
    slot_of = {k: i for i, k in enumerate(order)}
    T = int(round(seconds / frame_sec))
    labels = np.zeros((T, 4), np.float32)
    ref = []
    for k, s, e in segs:
        f0, f1 = int(round(s / frame_sec)), int(round(e / frame_sec))
        labels[f0 : min(f1, T), slot_of[k]] = 1.0
        ref.append((f"spk{k}", s, e))
    return mix, ref, labels


def lseend_batch(
    rs: np.random.RandomState,
    batch: int,
    n_steps: int,
    step_frames: int = 5,
    overlap_prob: float = 0.1,
) -> tuple[np.ndarray, np.ndarray]:
    """LS-EEND training batch: (audio8k [B, n_steps*step_frames*800],
    labels [B, n_steps*step_frames, 10]).

    Audio is the 2-speaker mixture resampled to the model's native 8 kHz with
    the SAME `utils.converter.resample` the manager's public path uses, so
    train == inference preprocessing exactly. Labels are arrival-order on the
    100 ms frame grid, zero-padded to the 10 attractor slots."""
    from fluidaudio_tpu_torch.models.lseend import LSEEND_SAMPLE_RATE, MAX_SPEAKERS
    from fluidaudio_tpu_torch.utils.converter import resample

    frames = n_steps * step_frames
    seconds = frames * 0.1
    step_samples = step_frames * LSEEND_SAMPLE_RATE // 10
    audio = np.zeros((batch, n_steps * step_samples), np.float32)
    labels = np.zeros((batch, frames, MAX_SPEAKERS), np.float32)
    for b in range(batch):
        mix, _, lab = diarizer_mixture(rs, seconds, overlap_prob=overlap_prob,
                                       frame_sec=0.1)
        a8 = resample(mix, SR, LSEEND_SAMPLE_RATE)
        audio[b, : min(a8.size, audio.shape[1])] = a8[: audio.shape[1]]
        labels[b, : min(lab.shape[0], frames), : lab.shape[1]] = lab[:frames]
    return audio, labels


def sortformer_batch(
    rs: np.random.RandomState,
    batch: int,
    mel_window: int = 3072,
    overlap_prob: float = 0.15,
) -> tuple[np.ndarray, np.ndarray]:
    """(audio [B, mel_window*160], labels [B, mel_window//8, 4])."""
    seconds = mel_window * 160 / SR
    audio = np.zeros((batch, mel_window * 160), np.float32)
    labels = np.zeros((batch, mel_window // 8, 4), np.float32)
    for b in range(batch):
        mix, _, lab = diarizer_mixture(rs, seconds, overlap_prob=overlap_prob)
        audio[b, : mix.size] = mix[: audio.shape[1]]
        labels[b, : lab.shape[0]] = lab[: labels.shape[1]]
    return audio, labels
