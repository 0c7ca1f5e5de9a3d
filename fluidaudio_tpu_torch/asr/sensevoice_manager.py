"""SenseVoiceManager: non-autoregressive multilingual ASR (50+ languages), in PyTorch.

Port of `fluidaudio_tpu/asr/sensevoice_manager.py` (reference
`SenseVoice/SenseVoiceManager.swift:4-40`): mel (80 bins, per-feature
normalised) -> 560-d LFR features -> SANM encoder + CTC head -> greedy CTC
collapse, all on the device for one padded (5/10/20/30 s) bucket, then ONE
device->host copy of the tokens, frames and count; the host detokenizes and
strips the `<|lang|>...` tags. Input longer than 30 s runs as sequential
30 s windows whose texts and timings are concatenated.

Weights: `checkpoint_dir` holds `encoder.npz` (+ `vocab.json`);
`checkpoint_dir=None` reads the model cache's `Repo.SENSEVOICE` folder, as
JAX does; with no checkpoint the weights are seeded random (with a warning),
drawn on `device`. `device=None` is the GPU; pass "cpu" to run on the CPU.
"""

from __future__ import annotations

import re
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from fluidaudio_tpu_torch.asr.config import ASRResult, TokenTiming
from fluidaudio_tpu_torch.models.sensevoice import (
    LFR_N,
    PROMPT_LEN,
    SENSEVOICE_SMALL,
    SenseVoiceConfig,
    SenseVoiceEncoder,
    lfr_stack,
)
from fluidaudio_tpu_torch.models.zoo import disable_tf32, family_tokenizer, load_or_init
from fluidaudio_tpu_torch.ops.ctc_decode import ctc_greedy_decode
from fluidaudio_tpu_torch.ops.mel import MelConfig, MelFrontend
from fluidaudio_tpu_torch.registry import DownloadUtils, Repo
from fluidaudio_tpu_torch.utils.device import resolve_device

LANGUAGES = {"auto": 0, "zh": 1, "en": 2, "yue": 3, "ja": 4, "ko": 5}
_TAG_RE = re.compile(r"<\|[^|]*\|>")

# audio-length buckets in seconds (enumerated shapes, reference's buckets)
_BUCKETS_S = (5, 10, 20, 30)


class SenseVoiceManager:
    def __init__(
        self,
        config: SenseVoiceConfig | None = None,
        *,
        checkpoint_dir: str | Path | None = None,
        rng_seed: int = 0,
        device: torch.device | str | None = None,
    ):
        self.cfg = config or SENSEVOICE_SMALL
        self.device = resolve_device(device)
        disable_tf32()
        self.encoder = SenseVoiceEncoder(self.cfg, device=self.device).eval()
        # FunASR fbank: 80 mel, no normalization in-model (CMVN applied here)
        self.mel = MelFrontend(MelConfig(n_mels=80, normalize="per_feature"),
                               device=self.device)
        base = Path(checkpoint_dir) if checkpoint_dir else DownloadUtils.repo_dir(Repo.SENSEVOICE)
        load_or_init(self.encoder, base / "encoder.npz", rng_seed, self.device, "SenseVoice")
        self.tokenizer = family_tokenizer(base, self.cfg.vocab_size)

    @torch.no_grad()
    def run_window(self, audio: torch.Tensor, lengths: torch.Tensor, lang_ids: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """audio [B, N] on the device -> CTC (tokens, frames, counts) on the device."""
        mel, mel_len = self.mel(audio, lengths)
        lfr, lfr_len = lfr_stack(mel, mel_len)
        log_probs = self.encoder(lfr, lfr_len, lang_ids)
        return ctc_greedy_decode(log_probs, lfr_len + PROMPT_LEN, self.cfg.blank_id)

    def transcribe(
        self, audio: np.ndarray, language: str = "auto", sample_rate: int = 16_000
    ) -> ASRResult:
        t0 = time.perf_counter()
        samples = np.asarray(audio, np.float32).reshape(-1)
        duration = samples.size / sample_rate
        max_window = _BUCKETS_S[-1] * 16000
        if samples.size > max_window:
            # long-form: sequential max-bucket windows, concatenated text
            # (the non-autoregressive decode carries no cross-window state)
            texts, timings_all = [], []
            for w0 in range(0, samples.size, max_window):
                part = self.transcribe(samples[w0 : w0 + max_window], language, sample_rate)
                texts.append(part.text)
                shift = w0 / sample_rate
                timings_all.extend(
                    replace(t, start_time=t.start_time + shift, end_time=t.end_time + shift)
                    for t in part.token_timings
                )
            return ASRResult(
                text=" ".join(x for x in texts if x).strip(),
                confidence=1.0,
                duration=duration,
                processing_time=time.perf_counter() - t0,
                token_timings=timings_all,
            )
        bucket_s = next((b for b in _BUCKETS_S if b * 16000 >= samples.size), _BUCKETS_S[-1])
        width = bucket_s * 16000
        padded = np.zeros(width, np.float32)
        padded[: min(samples.size, width)] = samples[:width]

        dev = self.device
        tokens, frames, counts = self.run_window(
            torch.from_numpy(padded)[None].to(dev),
            torch.tensor([min(samples.size, width)], dtype=torch.int32, device=dev),
            torch.tensor([LANGUAGES.get(language, 0)], dtype=torch.int32, device=dev),
        )
        host = torch.cat([counts[:, None], tokens, frames], dim=1)[0].cpu().numpy()
        n = int(host[0])
        ids = [int(t) for t in host[1 : 1 + n]]
        frame_idx = host[1 + tokens.shape[1] : 1 + tokens.shape[1] + n]
        raw_text = self.tokenizer.decode(ids)
        text = _TAG_RE.sub("", raw_text).strip()

        spf = LFR_N * 0.01  # seconds per LFR frame
        timings = [
            TokenTiming(
                token=self.tokenizer.piece(tid),
                token_id=tid,
                start_time=max(0.0, (int(f) - PROMPT_LEN)) * spf,
                end_time=(max(0.0, int(f) - PROMPT_LEN) + 1) * spf,
                confidence=1.0,
            )
            for tid, f in zip(ids, frame_idx)
            # keep timings aligned with the returned text: the prompt-slot
            # tags are stripped from it
            if not _TAG_RE.fullmatch(self.tokenizer.piece(tid) or "")
        ]
        return ASRResult(
            text=text,
            confidence=1.0,
            duration=duration,
            processing_time=time.perf_counter() - t0,
            token_timings=timings,
        )
