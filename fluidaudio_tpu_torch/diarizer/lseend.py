"""LSEENDDiarizer: streaming manager (8 kHz, 100 ms frames), in PyTorch.

Port of `fluidaudio_tpu/diarizer/lseend.py` (reference
`LS-EEND/LSEENDDiarizer.swift:17`): resample to 8 kHz, log-mel + CMN per
step, subsample with context, recurrent inference with step sizes
100-500 ms, 900 ms warm-up, up to 10 speakers.

The mel is normalised per step: each step's 8 kHz buffer
(`step_frames` x 800 samples) is its own row of the frontend, so computing
every step's mel in one batched call is the JAX manager's per-step mel.
`process` does that: the recording goes to the device in one copy, mel and
context stacking run batched over all steps, the recurrent step loops on the
device (`models/lseend.py::StepProgram`, a CUDA graph on the card) and the
activities come back in one copy. `process_stream` and `enroll_speaker` run
the steps they have in the same way, one copy back per call.

Weights: `checkpoint_dir` holds `<variant>/model_<step>ms.npz`,
`<variant>/model.npz` or `model.npz`; `checkpoint_dir=None` reads the model
cache's `Repo.LS_EEND` folder, as JAX does; with no checkpoint the weights
are seeded random (with a warning), drawn on `device`. `device=None` is the
GPU; pass "cpu" to run on the CPU.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from fluidaudio_tpu_torch.convert.lseend import LSEEND_VARIANTS  # noqa: F401 (re-exported)
from fluidaudio_tpu_torch.diarizer.types import (
    DiarizationResult,
    PipelineTimings,
    TimedSpeakerSegment,
)
from fluidaudio_tpu_torch.models.lseend import (
    FRAME_SECONDS,
    LSEEND_BASE,
    LSEEND_SAMPLE_RATE,
    MAX_SPEAKERS,
    LsEendConfig,
    LsEendModel,
    LsEendState,
    StepProgram,
    init_state,
    subsample_with_context,
)
from fluidaudio_tpu_torch.models.zoo import disable_tf32, random_init_
from fluidaudio_tpu_torch.ops.mel import MelConfig, MelFrontend
from fluidaudio_tpu_torch.registry import DownloadUtils, Repo
from fluidaudio_tpu_torch.utils.chunk_queue import StreamingChunkQueue
from fluidaudio_tpu_torch.utils.converter import resample
from fluidaudio_tpu_torch.utils.device import resolve_device
from fluidaudio_tpu_torch.utils.logging import get_logger
from fluidaudio_tpu_torch.utils.weights import load_npz, load_state

logger = get_logger("diarizer.lseend")


class LSEENDDiarizer:
    def __init__(
        self,
        config: LsEendConfig | None = None,
        *,
        step_ms: int = 500,
        threshold: float = 0.5,
        variant: str = "dih3",
        checkpoint_dir: str | Path | None = None,
        rng_seed: int = 0,
        device: torch.device | str | None = None,
    ):
        """`variant` selects one of the 4 upstream fine-tunes
        (ami/ch/dih2/dih3, reference ModelNames.swift:49-52); each ships
        per-step-size weights."""
        if not (100 <= step_ms <= 500 and step_ms % 100 == 0):
            raise ValueError(f"step_ms must be 100, 200, ..., 500, got {step_ms}")
        if variant not in LSEEND_VARIANTS:
            raise ValueError(f"variant must be one of {LSEEND_VARIANTS}, got {variant!r}")
        self.variant = variant
        self.cfg = config or LSEEND_BASE
        self.step_frames = step_ms // 100
        self.threshold = threshold
        self.device = resolve_device(device)
        disable_tf32()
        self.model = LsEendModel(self.cfg, device=self.device).eval()
        # 8 kHz mel: 10 ms hop, 25 ms window, CMN per feature
        self.mel = MelFrontend(
            MelConfig(
                sample_rate=LSEEND_SAMPLE_RATE, n_mels=self.cfg.n_mels,
                n_fft=256, hop_length=80, win_length=200, normalize="per_feature",
            ),
            device=self.device,
        )
        base = Path(checkpoint_dir) if checkpoint_dir else DownloadUtils.repo_dir(Repo.LS_EEND)
        gen = torch.Generator(device=self.device).manual_seed(rng_seed)
        random_init_(self.model, gen)
        with torch.no_grad():
            self.model.slot_init.copy_(torch.randn(self.model.slot_init.shape, generator=gen,
                                                   device=self.device) * 0.02)
        # per-variant/step asset layout mirrors the reference repo subfolders
        candidates = [
            base / variant / f"model_{step_ms}ms.npz",
            base / variant / "model.npz",
            base / "model.npz",
        ]
        ckpt = next((c for c in candidates if c.exists()), candidates[-1])
        if ckpt.exists():
            load_state(self.model, load_npz(ckpt))
        else:
            logger.warning("ls-eend: no checkpoint at %s — seeded random init", ckpt)
        self._program = StepProgram(self.model)
        # persistent streaming session: the recurrent state carries enrolled
        # identity across calls (ref `LSEENDDiarizer` enrollSpeaker,
        # exercised by SpeakerEnrollmentTests.swift:366-556)
        self._session_state = self.make_state()
        self._session_frames = 0
        self._session_queue = StreamingChunkQueue(self.step_samples)
        self._slot_names: dict[int, str] = {}

    @property
    def step_samples(self) -> int:
        """8 kHz samples per step."""
        return self.step_frames * LSEEND_SAMPLE_RATE // 10

    def make_state(self) -> LsEendState:
        return init_state(self.cfg, 1, self.device)

    # ------------------------------------------------------------- enrollment

    @property
    def speaker_names(self) -> dict[int, str]:
        return dict(self._slot_names)

    def reset_session(self) -> None:
        self._session_state = self.make_state()
        self._session_frames = 0
        self._slot_names = {}
        self._session_queue.reset()

    def enroll_speaker(
        self,
        samples: np.ndarray,
        sample_rate: int = 16_000,
        name: str | None = None,
        overwrite_assigned_name: bool = True,
    ) -> str | None:
        """Warm the recurrent session with a known speaker's audio and name
        the track the model assigns it. The frame clock resets so subsequent
        streaming starts at frame zero (enrollment does not offset the
        timeline — ref SpeakerEnrollmentTests :409-480)."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        audio8k = resample(samples, sample_rate, LSEEND_SAMPLE_RATE)
        step = self.step_samples
        if audio8k.size < step:
            logger.warning("enroll: need >= %d ms of audio", self.step_frames * 100)
            return None
        n = audio8k.size // step  # whole steps only
        acts, self._session_state = self.run_steps(
            audio8k[: n * step].reshape(n, step), self._session_state)
        speech_frames = (acts >= self.threshold).sum(axis=0).astype(np.int64)
        best = int(np.argmax(speech_frames))
        if speech_frames[best] == 0:
            logger.warning("enroll: no speech detected — speaker not enrolled")
            self._session_frames = 0
            return None
        if best in self._slot_names and not overwrite_assigned_name:
            logger.warning(
                "enroll: matched existing speaker %r at track %d and "
                "overwrite_assigned_name=False", self._slot_names[best], best,
            )
            self._session_frames = 0
            return None
        assigned = name or f"Speaker {best + 1}"
        self._slot_names[best] = assigned
        self._session_frames = 0
        return assigned

    def process_stream(
        self, samples: np.ndarray, sample_rate: int = 16_000
    ) -> DiarizationResult:
        """Streaming pass continuing the persistent session (state + names +
        frame clock). Partial trailing steps are QUEUED, not zero-padded:
        they complete on the next call (or `finish_stream`) — reference
        `StreamingChunkQueue` semantics (`LSEENDQueueTests.swift`)."""
        t0 = time.perf_counter()
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._session_queue.append(resample(samples, sample_rate, LSEEND_SAMPLE_RATE))
        steps = []
        while self._session_queue.has_chunk:
            steps.append(self._session_queue.pop_next_chunk())
        if steps:
            activities, self._session_state = self.run_steps(
                np.stack(steps), self._session_state)
        else:
            activities = np.zeros((0, MAX_SPEAKERS), np.float32)
        n_frames = len(activities)
        segments = self._to_segments(
            activities, names=self._slot_names, frame_offset=self._session_frames)
        self._session_frames += n_frames
        return DiarizationResult(
            segments=segments,
            speaker_count=len({s.speaker_id for s in segments}),
            timings=PipelineTimings(total_seconds=time.perf_counter() - t0),
        )

    def finish_stream(self) -> DiarizationResult:
        """Finalize the session: drain the queued partial tail (zero-padded
        to one full step — the ONLY place padding is allowed) and emit its
        segments. Idempotent once drained (reference
        `testFinalizeSessionDrainsUnprocessedAudioAndMelFeatures` /
        `testFinalizeSessionIsIdempotent`)."""
        t0 = time.perf_counter()
        tail = self._session_queue.pop_tail()
        frame_samples = LSEEND_SAMPLE_RATE // 10
        if tail.size == 0:
            return DiarizationResult(
                segments=[], speaker_count=0,
                timings=PipelineTimings(total_seconds=time.perf_counter() - t0),
            )
        acts, self._session_state = self.process_step(tail, self._session_state)
        n_frames = min(len(acts), -(-tail.size // frame_samples))
        segments = self._to_segments(
            acts[:n_frames], names=self._slot_names, frame_offset=self._session_frames)
        self._session_frames += n_frames
        return DiarizationResult(
            segments=segments,
            speaker_count=len({s.speaker_id for s in segments}),
            timings=PipelineTimings(total_seconds=time.perf_counter() - t0),
        )

    @torch.no_grad()
    def step_program(self, buffers: torch.Tensor, state: LsEendState
                     ) -> tuple[torch.Tensor, LsEendState]:
        """Step buffers [N, step_samples] (8 kHz, f32) on the device ->
        batched per-step mel + CMN -> context stacking -> the recurrent step
        over the N blocks -> (activities [N * step_frames, 10], state), all
        on the device."""
        mel, _ = self.mel(buffers)  # [N, n_mels, T]; each row normalised alone
        mel = mel[:, :, : self.step_frames * self.cfg.subsample]
        feats = subsample_with_context(mel, self.cfg)  # [N, step_frames, feat_dim]
        acts, state = self._program.scan(feats, state)
        return acts.reshape(-1, MAX_SPEAKERS), state

    def run_steps(self, buffers: np.ndarray, state: LsEendState
                  ) -> tuple[np.ndarray, LsEendState]:
        """Host step buffers [N, step_samples] -> (activities
        [N * step_frames, 10] on the host, state): one copy each way."""
        acts, state = self.step_program(
            torch.as_tensor(np.ascontiguousarray(buffers, np.float32)).to(self.device), state)
        return acts.cpu().numpy(), state

    def process_step(
        self, samples_8k: np.ndarray, state: LsEendState
    ) -> tuple[np.ndarray, LsEendState]:
        """One step of `step_frames` x 100 ms of 8 kHz audio (zero-padded or
        cut to one step)."""
        need = self.step_samples
        buf = np.zeros(need, np.float32)
        buf[: min(len(samples_8k), need)] = samples_8k[:need]
        return self.run_steps(buf[None], state)

    def process(self, samples: np.ndarray, sample_rate: int = 16_000) -> DiarizationResult:
        t0 = time.perf_counter()
        samples = np.asarray(samples, np.float32).reshape(-1)
        audio8k = resample(samples, sample_rate, LSEEND_SAMPLE_RATE)
        step = self.step_samples
        n_steps = -(-audio8k.size // step)
        if n_steps:
            buffers = np.zeros(n_steps * step, np.float32)
            buffers[: audio8k.size] = audio8k
            activities, _ = self.run_steps(buffers.reshape(n_steps, step), self.make_state())
        else:
            activities = np.zeros((0, MAX_SPEAKERS), np.float32)
        n_frames = min(len(activities), int(audio8k.size / (LSEEND_SAMPLE_RATE // 10)))
        segments = self._to_segments(activities[:n_frames])
        return DiarizationResult(
            segments=segments,
            speaker_count=len({s.speaker_id for s in segments}),
            timings=PipelineTimings(total_seconds=time.perf_counter() - t0),
        )

    def _to_segments(
        self,
        activities: np.ndarray,
        names: dict[int, str] | None = None,
        frame_offset: int = 0,
    ) -> list[TimedSpeakerSegment]:
        segments = []
        names = names or {}
        T = len(activities)
        for s in range(MAX_SPEAKERS):
            active = activities[:, s] >= self.threshold
            start = None
            for f in range(T + 1):
                on = f < T and active[f]
                if on and start is None:
                    start = f
                elif not on and start is not None:
                    segments.append(
                        TimedSpeakerSegment(
                            speaker_id=names.get(s, f"spk{s}"),
                            start_time=(frame_offset + start) * FRAME_SECONDS,
                            end_time=(frame_offset + f) * FRAME_SECONDS,
                        )
                    )
                    start = None
        segments.sort(key=lambda x: x.start_time)
        return segments
