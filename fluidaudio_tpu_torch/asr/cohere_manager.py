"""CoherePipeline: encoder-decoder multilingual ASR manager (14 languages), in PyTorch.

Port of `fluidaudio_tpu/asr/cohere_manager.py` (reference
`Cohere/CoherePipeline.swift:5-80`): mel (natural log, per-feature CMVN,
f_max 8000), a 35 s per-call cap, the KV-cache greedy decode with the
repetition penalty and the no-repeat-n-gram ban, and long-form input as 35 s
windows with 5 s overlap whose token streams merge at the seams.

The windows run as batches of up to `WINDOW_BATCH` rows, each padded to the
same width as in JAX: mel -> encoder -> the decode loop on the device.
JAX's stopping rule already gives each row the same steps as it would take
alone, so a batched window runs the same math per row as a window alone.
The cross-attention keys and values of the encoder output are projected
once, before the loop; the loop reads its stopping rule on the host once per
8 steps (`models/cohere_asr.py`); one device->host copy per batch brings the
tokens and counts back; the seams merge in window order on the host.
`window_decodes` keeps each batch's decode result (with its steps and host
syncs) of the last `transcribe`, `window_count` its number of windows.

Weights: `checkpoint_dir` holds `encoder.npz` and `decoder.npz` (+
`vocab.json`); `checkpoint_dir=None` reads the model cache's `Repo.COHERE`
folder, as JAX does; a missing part is seeded random, drawn on `device`.
`device=None` is the GPU; pass "cpu" to run on the CPU.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from fluidaudio_tpu_torch.asr.config import ASRResult
from fluidaudio_tpu_torch.models.cohere_asr import (
    COHERE_BASE,
    CohereConfig,
    CohereDecodeResult,
    CohereDecoderStep,
    CohereEncoder,
    cohere_greedy_decode,
)
from fluidaudio_tpu_torch.models.zoo import disable_tf32, family_tokenizer, load_or_init
from fluidaudio_tpu_torch.ops.mel import MelConfig, MelFrontend
from fluidaudio_tpu_torch.registry import DownloadUtils, Repo
from fluidaudio_tpu_torch.utils.device import resolve_device

MAX_CALL_SECONDS = 35.0
OVERLAP_SECONDS = 5.0  # CohereAsrConfig.chunkOverlapSeconds (hop = 30 s)
# windows decoded together: two cover 65 s; at the test config's 0.63 s cap
# a 1 s input makes 5,921 windows
WINDOW_BATCH = 16


class CoherePipeline:
    def __init__(
        self,
        config: CohereConfig | None = None,
        *,
        checkpoint_dir: str | Path | None = None,
        rng_seed: int = 0,
        device: torch.device | str | None = None,
    ):
        self.cfg = config or COHERE_BASE
        self.device = resolve_device(device)
        disable_tf32()
        self.encoder = CohereEncoder(self.cfg, device=self.device).eval()
        self.decoder = CohereDecoderStep(self.cfg, device=self.device).eval()
        # natural-log mel with per-feature CMVN (ddof=1) and fmax 8000
        # (reference CohereMelSpectrogram, CohereAsrConfig.MelSpec)
        self.mel = MelFrontend(MelConfig(n_mels=self.cfg.n_mels, normalize="per_feature",
                                         f_max=8000.0), device=self.device)
        base = Path(checkpoint_dir) if checkpoint_dir else DownloadUtils.repo_dir(Repo.COHERE)
        load_or_init(self.encoder, base / "encoder.npz", rng_seed, self.device, "Cohere encoder")
        load_or_init(self.decoder, base / "decoder.npz", rng_seed + 1, self.device,
                     "Cohere decoder")
        self.tokenizer = family_tokenizer(base, self.cfg.vocab_size)
        self.window_decodes: list[CohereDecodeResult] = []
        self.window_count = 0

    @torch.no_grad()
    def run_window(self, audio: torch.Tensor, lengths: torch.Tensor) -> CohereDecodeResult:
        """audio [B, N] on the device -> the greedy decode of each row."""
        cfg = self.cfg
        mel, mel_len = self.mel(audio, lengths)
        mel = mel[:, :, : cfg.max_audio_frames]
        mel_len = torch.clamp(mel_len, max=cfg.max_audio_frames)
        enc, enc_mask = self.encoder(mel, mel_len)
        cross = self.decoder.cross_kv(enc)

        def step(token, pos, k, v, e, m):
            return self.decoder(token, pos, k, v, e, m, cross=cross)

        return cohere_greedy_decode(cfg, step, enc, enc_mask)

    def transcribe(self, audio: np.ndarray, sample_rate: int = 16_000) -> ASRResult:
        t0 = time.perf_counter()
        cfg = self.cfg
        samples = np.asarray(audio, np.float32).reshape(-1)
        duration = samples.size / sample_rate
        # per-call cap: min(35 s, the model's max audio frames)
        cap = min(int(MAX_CALL_SECONDS * sample_rate), (cfg.max_audio_frames - 1) * 160)
        width = min(cap, max(16_000, 1 << int(np.ceil(np.log2(max(1, samples.size))))))
        # long-form: 35 s windows with 5 s overlap (hop 30 s), token-level
        # overlap dedup at the seams (reference CoherePipeline.swift:541-574)
        hop = max(1, cap - int(OVERLAP_SECONDS * sample_rate))
        segments = []
        for start in range(0, max(1, samples.size - int(samples.size > cap)), hop):
            seg = samples[start : start + cap]
            if seg.size == 0:
                break
            segments.append(seg[:width])
            if start + cap >= samples.size:
                break
        merged: list[int] = []
        self.window_decodes, self.window_count = [], len(segments)
        for b0 in range(0, len(segments), WINDOW_BATCH):
            group = segments[b0 : b0 + WINDOW_BATCH]
            padded = np.zeros((len(group), width), np.float32)
            for row, seg in enumerate(group):
                padded[row, : seg.size] = seg
            result = self.run_window(
                torch.from_numpy(padded).to(self.device),
                torch.tensor([seg.size for seg in group], dtype=torch.int32,
                             device=self.device),
            )
            self.window_decodes.append(result)
            host = torch.cat([result.counts[:, None], result.tokens], dim=1).cpu().numpy()
            for row in host:
                ids = [int(t) for t in row[1 : 1 + int(row[0])]
                       if int(t) not in (cfg.bos_id, cfg.eos_id, cfg.pad_id)]
                merged = merge_token_streams(merged, ids)
        return ASRResult(
            text=self.tokenizer.decode(merged).strip(),
            confidence=1.0,
            duration=duration,
            processing_time=time.perf_counter() - t0,
        )


def merge_token_streams(
    prefix: list[int],
    suffix: list[int],
    window_tokens: int = 32,
    min_match: int = 4,
) -> list[int]:
    """Merge adjacent chunk token streams by longest common substring.

    Both chunks re-decode ~5 s of identical seam audio; search a bounded
    window (last/first `window_tokens`) for the longest common run. On a hit
    of length >= `min_match`, keep the prefix as-is and drop the suffix's
    matched head; on a miss concatenate plainly — better to duplicate a few
    tokens than to lose content (ref `CoherePipeline.swift:592-634`).
    """
    if not prefix:
        return list(suffix)
    if not suffix:
        return list(prefix)
    p_tail = prefix[-window_tokens:]
    s_head = suffix[:window_tokens]
    m, n = len(p_tail), len(s_head)
    dp = [0] * (n + 1)
    best_len = 0
    best_s_end = 0  # exclusive end index in s_head
    for i in range(1, m + 1):
        prev_diag = 0
        for j in range(1, n + 1):
            temp = dp[j]
            if p_tail[i - 1] == s_head[j - 1]:
                dp[j] = prev_diag + 1
                if dp[j] > best_len:
                    best_len = dp[j]
                    best_s_end = j
            else:
                dp[j] = 0
            prev_diag = temp
    if best_len < min_match:
        return list(prefix) + list(suffix)
    return list(prefix) + list(suffix[best_s_end:])
