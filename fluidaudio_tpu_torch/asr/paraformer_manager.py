"""ParaformerManager: non-autoregressive Mandarin ASR, in PyTorch.

Port of `fluidaudio_tpu/asr/paraformer_manager.py` (reference
`Paraformer/ParaformerManager.swift:10` + `ParaformerCif.swift`): mel ->
LFR -> SANM encoder -> CIF -> parallel decoder -> argmax, all on the device
for one padded (5/10/20/30 s) bucket, then ONE device->host copy of the
tokens and count. Input longer than 30 s runs as sequential 30 s windows
whose texts are concatenated.

Weights: `checkpoint_dir` holds `model.npz` (+ `vocab.json`);
`checkpoint_dir=None` reads the model cache's `Repo.PARAFORMER` folder, as
JAX does; with no checkpoint the weights are seeded random (with a warning),
drawn on `device`. `device=None` is the GPU; pass "cpu" to run on the CPU.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from fluidaudio_tpu_torch.asr.config import ASRResult
from fluidaudio_tpu_torch.models.paraformer import PARAFORMER_LARGE, Paraformer, ParaformerConfig
from fluidaudio_tpu_torch.models.sensevoice import lfr_stack
from fluidaudio_tpu_torch.models.zoo import disable_tf32, family_tokenizer, load_or_init
from fluidaudio_tpu_torch.ops.mel import MelConfig, MelFrontend
from fluidaudio_tpu_torch.registry import DownloadUtils, Repo
from fluidaudio_tpu_torch.utils.device import resolve_device

_BUCKETS_S = (5, 10, 20, 30)


class ParaformerManager:
    def __init__(
        self,
        config: ParaformerConfig | None = None,
        *,
        checkpoint_dir: str | Path | None = None,
        rng_seed: int = 0,
        device: torch.device | str | None = None,
    ):
        self.cfg = config or PARAFORMER_LARGE
        self.device = resolve_device(device)
        disable_tf32()
        self.model = Paraformer(self.cfg, device=self.device).eval()
        self.mel = MelFrontend(MelConfig(n_mels=80, normalize="per_feature"),
                               device=self.device)
        base = Path(checkpoint_dir) if checkpoint_dir else DownloadUtils.repo_dir(Repo.PARAFORMER)
        load_or_init(self.model, base / "model.npz", rng_seed, self.device, "Paraformer")
        self.tokenizer = family_tokenizer(base, self.cfg.vocab_size)

    @torch.no_grad()
    def run_window(self, audio: torch.Tensor, lengths: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """audio [B, N] on the device -> (argmax tokens [B, U], counts [B]) on the device."""
        mel, mel_len = self.mel(audio, lengths)
        lfr, lfr_len = lfr_stack(mel, mel_len)
        logits, counts = self.model(lfr, lfr_len)
        return torch.argmax(logits, dim=-1).to(torch.int32), counts

    def transcribe(self, audio: np.ndarray, sample_rate: int = 16_000) -> ASRResult:
        t0 = time.perf_counter()
        samples = np.asarray(audio, np.float32).reshape(-1)
        duration = samples.size / sample_rate
        max_window = _BUCKETS_S[-1] * 16000
        if samples.size > max_window:
            # long-form: sequential max-bucket windows, concatenated text
            # (CIF decode carries no cross-window state)
            texts = [
                self.transcribe(samples[w0 : w0 + max_window], sample_rate).text
                for w0 in range(0, samples.size, max_window)
            ]
            return ASRResult(
                text="".join(texts).strip(),
                confidence=1.0,
                duration=duration,
                processing_time=time.perf_counter() - t0,
            )
        bucket_s = next((b for b in _BUCKETS_S if b * 16000 >= samples.size), _BUCKETS_S[-1])
        width = bucket_s * 16000
        padded = np.zeros(width, np.float32)
        padded[: min(samples.size, width)] = samples[:width]
        dev = self.device
        tokens, counts = self.run_window(
            torch.from_numpy(padded)[None].to(dev),
            torch.tensor([min(samples.size, width)], dtype=torch.int32, device=dev),
        )
        host = torch.cat([counts[:, None], tokens], dim=1)[0].cpu().numpy()
        n = int(host[0])
        text = self.tokenizer.decode([int(t) for t in host[1 : 1 + n]])
        return ASRResult(
            text=text,
            confidence=1.0,
            duration=duration,
            processing_time=time.perf_counter() - t0,
        )
