"""PocketTtsManager: streaming AR TTS with voice cloning, in PyTorch.

Port of `fluidaudio_tpu/tts/pocket_manager.py` (reference
`PocketTTS/PocketTtsManager.swift` + `PocketTtsSynthesizer.swift:142-287,
498-707`): text tokens and a 125-frame voice prompt prefill the KV cache,
then per 80 ms frame the flow decoder (8 Euler steps) turns the last
hidden state into a latent, Mimi decodes it (streaming states) and the
flow-LM steps on it (EOS logit threshold -4.0). Cloning Mimi-encodes a
1-30 s sample through a fixed 10 s window.

On `device` (None = the GPU):
- the prefill is one causal pass over [BOS | prompt | text] (`FlowLm.prefill`);
- `synthesize` keeps JAX's fixed trip count: `max_frames` frame steps
  (250 at full width) with a done mask (frames after the first EOS come
  out as zeros), all on the device; on the card the frame step is a CUDA
  graph (`FrameProgram`), replayed once per frame with its state in static
  buffers. The samples and the done flags come back in one copy;
- `stream` runs the same step in blocks of `STREAM_BLOCK_FRAMES`, state
  carried, one copy back per block.

The frame noise is a `torch.Generator`'s (`frame_noise`, `block_noise`):
JAX's threefry draws cannot be reproduced, so tests put JAX's draws in
their place.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from fluidaudio_tpu_torch.models.mimi import random_init_mimi_
from fluidaudio_tpu_torch.models.pocket_tts import (
    EOS_THRESHOLD,
    KV_POSITIONS,
    POCKET_BASE,
    SAMPLE_RATE,
    VOICE_PROMPT_FRAMES,
    FlowDecoder,
    FlowLm,
    KvCache,
    MimiDecoder,
    MimiEncoder,
    PocketTtsConfig,
    init_kv,
)
from fluidaudio_tpu_torch.models.zoo import disable_tf32, random_init_
from fluidaudio_tpu_torch.registry import DownloadUtils, Repo
from fluidaudio_tpu_torch.tts.pocket_text import chunk_text_with_metadata, normalize_text
from fluidaudio_tpu_torch.utils.device import resolve_device
from fluidaudio_tpu_torch.utils.logging import get_logger
from fluidaudio_tpu_torch.utils.weights import load_npz, load_state

logger = get_logger("tts.pocket")

_PREFILL_BUCKETS = (160, 192, 256, 384, 512)
MAX_TEXT_TOKENS = 256

# Voice-cloning window contract (PocketTtsVoiceCloner.swift:21-33): the Mimi
# encoder always consumes exactly 10 s @ 24 kHz and emits 125 frames.
ENCODER_INPUT_SAMPLES = 240_000
MIN_CLONE_SECONDS = 1.0


def make_encoder_input_buffer(samples: np.ndarray) -> np.ndarray:
    """Zero-pad or truncate to the fixed encoder window
    (`PocketTtsVoiceCloner.makeEncoderInputBuffer`)."""
    x = np.asarray(samples, np.float32).reshape(-1)
    buf = np.zeros(ENCODER_INPUT_SAMPLES, np.float32)
    n = min(x.size, ENCODER_INPUT_SAMPLES)
    buf[:n] = x[:n]
    return buf


def usable_frame_count(
    real_sample_count: int,
    available_frames: int,
    *,
    frame_size: int = 1920,
    max_voice_frames: int = VOICE_PROMPT_FRAMES,
) -> int:
    """Leading encoder frames covered by real (non-padding) audio:
    ceil(real/frame), capped at the KV budget and the encoder output
    (`PocketTtsVoiceCloner.usableFrameCount`)."""
    covered = -(-real_sample_count // frame_size)
    return max(1, min(covered, max_voice_frames, available_frames))


@dataclass
class PocketSynthesisResult:
    samples: np.ndarray
    sample_rate: int
    frames: int

    @property
    def duration(self) -> float:
        return self.samples.size / self.sample_rate


class FrameState:
    """The generation loop's carry as a flat list of tensors (batch 1): the
    flow-LM KV cache and position, the conditioning, the done flag, then the
    Mimi decoder's state."""

    def __init__(self, kv: KvCache, pos: torch.Tensor, cond: torch.Tensor,
                 done: torch.Tensor, mimi: dict):
        self.tensors = [kv.k, kv.v, pos, cond, done, mimi["kv"], mimi["pos"],
                        mimi["upsample"], *mimi["convs"]]

    @classmethod
    def of(cls, tensors: list[torch.Tensor]) -> "FrameState":
        st = cls.__new__(cls)
        st.tensors = list(tensors)
        return st

    @property
    def kv(self) -> KvCache:
        return KvCache(self.tensors[0], self.tensors[1])

    @property
    def pos(self) -> torch.Tensor:
        return self.tensors[2]

    @property
    def cond(self) -> torch.Tensor:
        return self.tensors[3]

    @property
    def done(self) -> torch.Tensor:
        return self.tensors[4]

    @property
    def mimi(self) -> dict:
        t = self.tensors
        return {"kv": t[5], "pos": t[6], "upsample": t[7], "convs": t[8:]}

    def clone(self) -> "FrameState":
        return FrameState.of([t.clone() for t in self.tensors])


class FrameProgram:
    """One generation frame: flow Euler -> Mimi step -> flow-LM step, with
    the done mask. `scan(noise [N, latent], state)` runs N frames on the
    device with no host sync -> (samples [N, hop], done flags [N], EOS
    logits [N], state).
    On a CUDA device the first call captures the frame as a CUDA graph over
    static state buffers that it updates in place; each frame then costs a
    copy of its noise in, one replay and two copies out. On the CPU it calls
    the frame directly."""

    def __init__(self, manager: "PocketTtsManager"):
        self.m = manager
        self.graph: torch.cuda.CUDAGraph | None = None

    def frame(self, noise: torch.Tensor, state: FrameState
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, FrameState]:
        m = self.m
        latent = m.flow(state.cond, noise)
        samples, mimi = m.mimi.step(latent, state.mimi)
        cond, eos, kv = m.flowlm.step(m.flowlm.embed_latent(latent), state.pos, state.kv)
        now_done = state.done | (eos > EOS_THRESHOLD)
        out = torch.where(state.done[:, None], torch.zeros_like(samples), samples)
        return out, now_done, eos, FrameState(kv, state.pos + 1, cond, now_done, mimi)

    def _capture(self, noise: torch.Tensor, state: FrameState) -> None:
        self.noise = noise.clone()
        self.state = state.clone()
        side = torch.cuda.Stream(noise.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up outside the graph
            self.frame(self.noise, self.state)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.samples, self.done, self.eos, new = self.frame(self.noise, self.state)
            for dst, src in zip(self.state.tensors, new.tensors):
                dst.copy_(src)

    @torch.no_grad()
    def scan(self, noise_all: torch.Tensor, state: FrameState
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, FrameState]:
        n = noise_all.shape[0]
        if noise_all.device.type != "cuda":
            outs, flags, logits = [], [], []
            for i in range(n):
                out, done, eos, state = self.frame(noise_all[i : i + 1], state)
                outs.append(out[0])
                flags.append(done[0])
                logits.append(eos[0])
            return torch.stack(outs), torch.stack(flags), torch.stack(logits), state
        if self.graph is None:
            self._capture(noise_all[:1], state)
        for dst, src in zip(self.state.tensors, state.tensors):
            dst.copy_(src)
        audio = torch.empty((n, self.samples.shape[1]), device=noise_all.device)
        flags = torch.empty((n,), dtype=torch.bool, device=noise_all.device)
        logits = torch.empty((n,), device=noise_all.device)
        for i in range(n):
            self.noise.copy_(noise_all[i : i + 1])
            self.graph.replay()
            audio[i].copy_(self.samples[0])
            flags[i].copy_(self.done[0])
            logits[i].copy_(self.eos[0])
        return audio, flags, logits, self.state.clone()


class PocketTtsManager:
    def __init__(
        self,
        config: PocketTtsConfig | None = None,
        *,
        language: str = "english",
        checkpoint_dir: str | Path | None = None,
        rng_seed: int = 0,
        device: torch.device | str | None = None,
    ):
        self.cfg = cfg = config or POCKET_BASE
        self.language = language
        self.device = dev = resolve_device(device)
        disable_tf32()
        self.flowlm = FlowLm(cfg, device=dev).eval()
        self.flow = FlowDecoder(cfg, device=dev).eval()
        self.mimi = MimiDecoder(cfg.mimi, device=dev).eval()
        self.mimi_enc = MimiEncoder(cfg.mimi, device=dev).eval()

        gen = torch.Generator(device=dev).manual_seed(rng_seed)
        random_init_(self.flowlm, gen)
        random_init_(self.flow, gen)
        random_init_mimi_(self.mimi, gen)
        random_init_mimi_(self.mimi_enc, gen)
        base = Path(checkpoint_dir) if checkpoint_dir else DownloadUtils.repo_dir(Repo.POCKET_TTS)
        # real SentencePiece vocab when cached (binary ModelProto, parsed by
        # asr/sentencepiece_model.py — no sentencepiece package needed)
        self.tokenizer = None
        sp_model = base / "tokenizer.model"
        if sp_model.exists():
            from fluidaudio_tpu_torch.asr.tokenizer import Tokenizer

            self.tokenizer = Tokenizer.from_sentencepiece(sp_model)
        for part in ("flowlm", "flow", "mimi", "mimi_enc"):
            f = base / f"{part}.npz"
            if f.exists():
                load_state(getattr(self, part), load_npz(f))
        self.frame_samples = cfg.mimi.hop  # 1920 at the base config
        self.voices: dict[str, np.ndarray] = self._load_voices(base)
        self.frame_program = FrameProgram(self)

    def _load_voices(self, base: Path) -> dict[str, np.ndarray]:
        f = base / "voices.npz"
        if f.exists():
            data = np.load(f)
            return {k: data[k] for k in data.files}
        rng = np.random.RandomState(3)
        return {"default": rng.randn(VOICE_PROMPT_FRAMES, self.cfg.mimi.latent_dim)
                .astype(np.float32) * 0.3}

    # ------------------------------------------------------------- voice clone

    @torch.no_grad()
    def clone_voice(self, samples_24k: np.ndarray, name: str,
                    voices_dir: str | Path | None = None) -> None:
        """Mimi-encode a reference sample into a 125-frame voice prompt
        (`PocketTtsVoiceCloner.swift:21-75`): a fixed 10 s window, then only
        the `ceil(real_samples / frame)` leading frames, tiled to fill the
        prompt."""
        x = np.asarray(samples_24k, np.float32).reshape(-1)
        if x.size < int(MIN_CLONE_SECONDS * SAMPLE_RATE):
            raise ValueError(
                f"voice sample too short: {x.size / SAMPLE_RATE:.2f}s "
                f"(minimum {MIN_CLONE_SECONDS}s required)"
            )
        real = min(x.size, ENCODER_INPUT_SAMPLES)
        buf = torch.as_tensor(make_encoder_input_buffer(x)).to(self.device)[None]
        latents = self.mimi_enc(buf)[0].cpu().numpy()
        usable = usable_frame_count(real, latents.shape[0], frame_size=self.frame_samples)
        kept = latents[:usable]
        reps = -(-VOICE_PROMPT_FRAMES // usable)
        self.voices[name] = np.tile(kept, (reps, 1))[:VOICE_PROMPT_FRAMES].astype(np.float32)
        if voices_dir:
            out = Path(voices_dir)
            out.mkdir(parents=True, exist_ok=True)
            np.savez(out / "voices.npz", **self.voices)

    # --------------------------------------------------------------- generate

    @torch.no_grad()
    def prefill(self, text_tokens: np.ndarray, prompt: np.ndarray
                ) -> tuple[KvCache, int, torch.Tensor]:
        """[BOS | voice prompt | text] through the flow-LM in one causal pass
        -> (kv, start position, the last position's hidden [1, D]). Text past
        the KV budget's largest prefill bucket is cut, as in JAX."""
        n_text = text_tokens.shape[1]
        total = 1 + VOICE_PROMPT_FRAMES + n_text
        if total > _PREFILL_BUCKETS[-1]:
            keep = _PREFILL_BUCKETS[-1] - 1 - VOICE_PROMPT_FRAMES
            text_tokens = text_tokens[:, :keep]
            total = 1 + VOICE_PROMPT_FRAMES + keep
        dev = self.device
        lm = self.flowlm
        seq = torch.cat([
            lm.bos[None],
            lm.embed_latent(torch.as_tensor(prompt, dtype=torch.float32, device=dev)),
            lm.embed_text(torch.as_tensor(text_tokens[0], device=dev)),
        ])[None]  # reference prefill order: BOS, voice prompt, text
        cond, kv = lm.prefill(seq, init_kv(self.cfg, 1, dev))
        return kv, total, cond

    def initial_state(self, kv: KvCache, pos: int, cond: torch.Tensor) -> FrameState:
        dev = self.device
        return FrameState(kv, torch.tensor([pos], device=dev), cond,
                          torch.zeros((1,), dtype=torch.bool, device=dev),
                          self.mimi.init_state(1))

    def frame_noise(self, seed: int, n_frames: int) -> torch.Tensor:
        """The `n_frames` frame noises [n, latent] of one `synthesize` chunk."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn((n_frames, self.cfg.mimi.latent_dim), generator=gen,
                           device=self.device)

    def block_noise(self, generator: torch.Generator) -> torch.Tensor:
        """The next stream block's noises [STREAM_BLOCK_FRAMES, latent]."""
        return torch.randn((self.STREAM_BLOCK_FRAMES, self.cfg.mimi.latent_dim),
                           generator=generator, device=self.device)

    def generate(self, kv: KvCache, pos: int, cond: torch.Tensor, noise: torch.Tensor
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """`noise.shape[0]` frame steps from the prefilled state (JAX's fixed
        trip count) -> (samples [n, hop], done flags [n], EOS logits [n]) on
        the host."""
        audio, done, eos, _ = self.frame_program.scan(noise, self.initial_state(kv, pos, cond))
        return audio.cpu().numpy(), done.cpu().numpy(), eos.cpu().numpy()

    def _count_tokens(self, text: str) -> int:
        return int(self._tokenize(text).shape[1])

    def synthesize(
        self,
        text: str,
        voice: str = "default",
        max_frames: int | None = None,
        seed: int = 0,
    ) -> PocketSynthesisResult:
        """Normalize + chunk the text (sentence/clause/word boundaries with
        mid-sentence prosody tags), synthesize each chunk, and concatenate."""
        chunks = chunk_text_with_metadata(text, self._count_tokens, language=self.language)
        pieces: list[PocketSynthesisResult] = []
        for i, chunk in enumerate(chunks):
            norm, frames_after_eos = normalize_text(chunk.text, chunk.is_mid_sentence,
                                                    self.language)
            pieces.append(self._synthesize_chunk(norm, voice, max_frames, seed + i,
                                                 frames_after_eos))
        if len(pieces) == 1:
            return pieces[0]
        return PocketSynthesisResult(
            samples=np.concatenate([p.samples for p in pieces]),
            sample_rate=SAMPLE_RATE,
            frames=sum(p.frames for p in pieces),
        )

    def _voice(self, voice: str) -> np.ndarray:
        prompt = self.voices.get(voice)
        if prompt is None:
            raise KeyError(f"unknown voice {voice!r}; available {sorted(self.voices)}")
        return prompt

    def _synthesize_chunk(
        self,
        text: str,
        voice: str = "default",
        max_frames: int | None = None,
        seed: int = 0,
        frames_after_eos: int = 0,
    ) -> PocketSynthesisResult:
        tokens = self._tokenize(text)
        prompt = self._voice(voice)
        max_frames = min(
            max_frames or self.cfg.max_frames,
            KV_POSITIONS - tokens.shape[1] - VOICE_PROMPT_FRAMES - 1,
        )
        kv, pos, first_cond = self.prefill(tokens, prompt)
        t0 = time.perf_counter()
        audio, done, _ = self.generate(kv, pos, first_cond, self.frame_noise(seed, max_frames))
        # keep a few frames past EOS detection for prosody tails (ref
        # shortTextPadFrames / longTextExtraFrames, issue #584)
        if done.any():
            n_frames = min(int(np.argmax(done)) + 1 + frames_after_eos, max_frames)
        else:
            n_frames = max_frames
        samples = audio[:n_frames].reshape(-1)
        logger.debug("pocket generate: %d frames in %.2fs", n_frames, time.perf_counter() - t0)
        return PocketSynthesisResult(samples=samples, sample_rate=SAMPLE_RATE, frames=n_frames)

    STREAM_BLOCK_FRAMES = 25  # 2 s per block

    @torch.no_grad()
    def stream(self, text: str, voice: str = "default", seed: int = 0) -> Iterator[np.ndarray]:
        """Yield frame sample blocks while generation continues: fixed-size
        blocks of frame steps, state carried between them, so first audio
        arrives after `STREAM_BLOCK_FRAMES` frames (the reference's
        `generatePipelined` contract, `PocketTtsSynthesizer.swift:590`)."""
        text, _ = normalize_text(text, language=self.language)
        tokens = self._tokenize(text)
        prompt = self._voice(voice)
        max_frames = min(
            self.cfg.max_frames,
            KV_POSITIONS - tokens.shape[1] - VOICE_PROMPT_FRAMES - 1,
        )
        kv, pos, cond = self.prefill(tokens, prompt)
        state = self.initial_state(kv, pos, cond)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        emitted = 0
        done = False
        while emitted < max_frames and not done:
            audio, flags, _, state = self.frame_program.scan(self.block_noise(gen), state)
            audio_np, flags_np = audio.cpu().numpy(), flags.cpu().numpy()
            done = bool(flags_np[-1])
            n = int(np.argmax(flags_np)) + 1 if flags_np.any() else flags_np.size
            n = min(n, max_frames - emitted)
            for i in range(n):
                yield audio_np[i]
            emitted += n

    def _tokenize(self, text: str) -> np.ndarray:
        """SentencePiece tokenizer when `tokenizer.model` is cached; the
        char-level stand-in otherwise. -> [1, n] int64 on the host."""
        if self.tokenizer is not None:
            ids: list[int] = []
            for word in text.split():
                enc = self.tokenizer.encode_word(word, word_initial=True)
                if enc is None:  # fall back per-char through the vocab
                    enc = [i for c in word
                           if (i := self.tokenizer._piece_to_id.get(c)) is not None]
                ids.extend(enc)
            ids = [min(i, self.cfg.vocab_size - 1) for i in ids[:MAX_TEXT_TOKENS]]
            return np.asarray([ids or [1]], np.int64)
        from fluidaudio_tpu_torch.tts.pocket_text import fallback_char_tokens

        return np.asarray([fallback_char_tokens(text, self.cfg.vocab_size, MAX_TEXT_TOKENS)],
                          np.int64)
