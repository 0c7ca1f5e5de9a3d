"""CtcKeywordSpotter: mel + encoder + CTC head -> keyword spotting manager.

Behavioral parity: reference `WordSpotting/CtcKeywordSpotter.swift:11-60`
(+Inference): 15 s chunks with 2 s overlap, temperature + blank-bias
preprocessing of the CTC log-probs, per-keyword DP spotting
(ops in custom_vocab/ctc_spotter.py), results merged across chunks.

Pairs with `VocabularyRescorer` for the full CTC-WS boosting flow
(Earnings22 benchmark path).

Port of `fluidaudio_tpu/asr/keyword_spotter.py`: each 15 s chunk runs
`MelFrontend(MelConfig(normalize="per_feature"))` -> `ConformerEncoder` ->
`log_softmax(enc @ head)` on the device (the encoder's f32 output times the
f32 [d, V+1] head). At the default parakeet-ctc-0.6b width (Dh 128) the
encoder launches the rel-pos attention kernel once per layer and chunk.
Each chunk's log-probs are copied off the device once; the seam merge and
the keyword DP run on the host. `checkpoint_dir` holds `encoder.npz` and
`ctc_head.npz` (key `head`); `checkpoint_dir=None` reads the model cache's
`Repo.PARAKEET_CTC_0_6B` folder, as JAX does. Where a part is missing its
weights are seeded random (with a warning).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch import nn

from fluidaudio_tpu_torch.asr.custom_vocab.context import CustomVocabularyContext
from fluidaudio_tpu_torch.asr.custom_vocab.ctc_spotter import KeywordSpot, spot_keywords
from fluidaudio_tpu_torch.models.conformer import ConformerConfig, ConformerEncoder
from fluidaudio_tpu_torch.models.zoo import disable_tf32, random_init_
from fluidaudio_tpu_torch.ops.mel import MelConfig, MelFrontend
from fluidaudio_tpu_torch.registry import DownloadUtils, Repo
from fluidaudio_tpu_torch.utils.device import resolve_device
from fluidaudio_tpu_torch.utils.logging import get_logger
from fluidaudio_tpu_torch.utils.weights import load_npz, load_state

logger = get_logger("asr.kws")

CHUNK_SAMPLES = 240_000  # 15 s
OVERLAP_SAMPLES = 32_000  # 2 s (nominal; stride below is frame-aligned)
FRAME_SECONDS = 0.08
FRAME_SAMPLES = 1280  # 80 ms encoder frames (10 ms mel hop x8 subsampling)
OVERLAP_FRAMES = OVERLAP_SAMPLES // FRAME_SAMPLES  # 25 encoder frames
# chunk stride MUST be an exact number of encoder frames: 240000-32000 =
# 208000 samples is 162.5 frames, which would merge every later chunk's
# log-probs half-a-frame misaligned with the canvas (observed as dropped
# words exactly at the 15 s seam). Round the stride DOWN to the frame grid
# (effective overlap 2.04 s >= the nominal 2 s).
CHUNK_STRIDE = (CHUNK_SAMPLES - OVERLAP_SAMPLES) // FRAME_SAMPLES * FRAME_SAMPLES
# frames at a chunk edge whose receptive field is truncated by the chunk
# boundary (conformer conv kernel ~ a few 80 ms frames each side); within an
# overlap these are replaced by the other chunk's interior frames
SEAM_EDGE_FRAMES = 4


def merge_overlap_frames(existing: np.ndarray, incoming: np.ndarray) -> np.ndarray:
    """Probability-space mean of two log-prob blocks: `logmeanexp(a, b) =
    logaddexp(a, b) - log 2` (reference
    `CtcKeywordSpotter+Inference.swift:329-345`). Equal inputs return
    themselves; both `-inf` propagates; one `-inf` defers to the other
    minus log 2; max-shifted so -50-ish log-probs stay finite."""
    existing = np.asarray(existing, np.float32)
    incoming = np.asarray(incoming, np.float32)
    v = min(len(existing), len(incoming))
    if v == 0:
        return existing
    merged = np.logaddexp(existing[:v], incoming[:v]) - np.float32(np.log(2.0))
    if len(existing) > v:
        return np.concatenate([merged, existing[v:]])
    return merged.astype(np.float32)


@dataclass(frozen=True)
class KeywordSpotterConfig:
    vocab_size: int = 1024  # CTC vocab (blank last)
    temperature: float = 1.0
    blank_bias: float = 0.0
    min_score: float = -2.5

    @property
    def blank_id(self) -> int:
        return self.vocab_size


class CtcHead(nn.Module):
    """The CTC output projection, `head` [d, V+1] f32 (the `ctc_head.npz`
    key), applied as `enc @ head`."""

    def __init__(self, d_model: int, n_out: int, device=None):
        super().__init__()
        self.head = nn.Parameter(torch.zeros(d_model, n_out, device=device))

    def forward(self, enc: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(enc @ self.head, dim=-1)


class CtcKeywordSpotter:
    def __init__(
        self,
        context: CustomVocabularyContext,
        config: KeywordSpotterConfig | None = None,
        encoder_cfg: ConformerConfig | None = None,
        *,
        checkpoint_dir: str | Path | None = None,
        rng_seed: int = 0,
        device: torch.device | str | None = None,
    ):
        """`device=None` is the GPU (RuntimeError without one); pass "cpu"
        to run on the CPU."""
        self.context = context
        self.cfg = config or KeywordSpotterConfig()
        self.device = resolve_device(device)
        disable_tf32()
        # default matches the default checkpoint repo (parakeet-ctc-0.6b:
        # 1024x24 — a 512x17 template would fail to load against it)
        enc_cfg = encoder_cfg or ConformerConfig(d_model=1024, n_layers=24)
        self.encoder = ConformerEncoder(enc_cfg, device=self.device).eval()
        self.ctc = CtcHead(enc_cfg.d_model, self.cfg.vocab_size + 1, device=self.device)
        self.mel = MelFrontend(MelConfig(normalize="per_feature"), device=self.device)

        gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        random_init_(self.encoder, gen)
        with torch.no_grad():
            self.ctc.head.copy_(torch.randn(self.ctc.head.shape, generator=gen,
                                            device=self.device) * 0.02)
        base = (Path(checkpoint_dir) if checkpoint_dir
                else DownloadUtils.repo_dir(Repo.PARAKEET_CTC_0_6B))
        loaded = []
        for name, part in (("encoder", self.encoder), ("ctc_head", self.ctc)):
            f = base / f"{name}.npz"
            if f.exists():
                load_state(part, load_npz(f))
                loaded.append(name)
        if len(loaded) < 2:
            logger.warning("keyword spotter: %s not in %s — seeded random init",
                           sorted({"encoder", "ctc_head"} - set(loaded)), base)

    @property
    def ctc_head(self) -> torch.Tensor:
        return self.ctc.head

    def _frames(self, n_samples: int) -> int:
        """Encoder frames a chunk with `n_samples` (<= CHUNK_SAMPLES) valid
        samples yields: the mel and encoder length rules, on the host, so
        the chunk's log-probs come back in one copy."""
        return self.encoder.cfg.out_length(self.mel.cfg.num_frames(n_samples))

    @torch.no_grad()
    def chunk_log_probs(self, audio: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """[B, CHUNK_SAMPLES] audio + valid lengths [B] on the device ->
        [B, T, V+1] f32 CTC log-probs (blank last) on the device."""
        mel, mel_len = self.mel(audio, lengths)
        enc, _ = self.encoder(mel, mel_len)
        return self.ctc(enc)

    def log_probs(self, samples: np.ndarray) -> np.ndarray | None:
        """Whole-recording CTC log-probs `[T, V+1]` (blank last): 15 s chunks
        with the 2 s overlaps merged probability-space (logmeanexp), the same
        canvas `spot()` searches — public so decode/rescoring consumers
        (Earnings22 CTC path) can share one acoustic pass."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        stride = CHUNK_STRIDE
        # concatenate all chunks' log-probs into ONE buffer, merging the 2 s
        # overlaps probability-space (logmeanexp), then spot once over the
        # whole recording — keywords spanning chunk boundaries survive
        # (reference `CtcKeywordSpotter+Inference.swift:106-139`)
        canvas: np.ndarray | None = None
        for start in range(0, max(1, samples.size), stride):
            seg = samples[start : start + CHUNK_SAMPLES]
            if seg.size < 4000 and start > 0:
                break
            buf = np.zeros(CHUNK_SAMPLES, np.float32)
            buf[: seg.size] = seg
            lp = self.chunk_log_probs(
                torch.from_numpy(buf)[None].to(self.device),
                torch.tensor([seg.size], dtype=torch.int32, device=self.device))
            n = self._frames(seg.size)
            # one device->host copy per chunk, then a writable host copy:
            # the seam merge below writes into the canvas in place
            chunk_lp = lp[0, :n].cpu().numpy().copy()
            if canvas is None or start == 0:
                canvas = chunk_lp
            else:
                # exact frame alignment: this chunk's frame 0 is global frame
                # start/FRAME_SAMPLES (stride is frame-aligned), so the true
                # overlap is whatever the canvas already covers past it —
                # NOT a fixed constant (the encoder may emit ceil-length
                # frame counts per chunk)
                ov = max(0, min(len(canvas) - start // FRAME_SAMPLES,
                                len(chunk_lp)))
                if ov > 0:
                    # edge-aware merge: a chunk's first/last few frames see
                    # zero-padding instead of real context (truncated
                    # receptive field), so logmeanexp-ing them with the other
                    # chunk's INTERIOR frames blurs the posterior (observed:
                    # a word dropped exactly at the previous chunk's final
                    # frame). Within the overlap, prefer the interior chunk
                    # at each edge and blend only the middle.
                    e = min(SEAM_EDGE_FRAMES, ov // 2)
                    tail = len(canvas) - ov
                    if ov > 2 * e:
                        canvas[tail + e : len(canvas) - e] = (
                            merge_overlap_frames(
                                canvas[tail + e : len(canvas) - e],
                                chunk_lp[e : ov - e],
                            )
                        )
                    if e > 0:
                        # previous chunk's edge -> take this chunk's interior
                        canvas[len(canvas) - e :] = chunk_lp[ov - e : ov]
                if ov < len(chunk_lp):
                    canvas = np.concatenate([canvas, chunk_lp[ov:]])
            if start + CHUNK_SAMPLES >= samples.size:
                break
        return canvas

    def spot(self, samples: np.ndarray) -> list[KeywordSpot]:
        """Spot all context terms across the recording (chunked, merged)."""
        keywords = {
            t.text: t.ctc_token_ids
            for t in self.context.terms
            if t.ctc_token_ids
        }
        if not keywords:
            logger.warning("no pre-tokenized terms; call context.pretokenize()")
            return []
        canvas = self.log_probs(samples)
        if canvas is None or not len(canvas):
            return []
        return spot_keywords(
            canvas, keywords, self.cfg.blank_id,
            min_score=self.cfg.min_score, temperature=self.cfg.temperature,
            blank_bias=self.cfg.blank_bias,
        )


def _dedupe_spots(spots: list[KeywordSpot]) -> list[KeywordSpot]:
    """Overlapping chunks can re-spot the same occurrence; keep the best."""
    spots.sort(key=lambda s: (s.keyword, s.start_frame))
    out: list[KeywordSpot] = []
    for s in spots:
        if (
            out
            and out[-1].keyword == s.keyword
            and s.start_frame <= out[-1].end_frame
        ):
            if s.score > out[-1].score:
                out[-1] = s
        else:
            out.append(s)
    out.sort(key=lambda s: s.start_frame)
    return out
