"""SortformerDiarizer: streaming + offline end-to-end diarization, in PyTorch.

Port of `fluidaudio_tpu/diarizer/sortformer.py` (reference
`Sortformer/SortformerDiarizer.swift:12`, `SortformerStateUpdater` cache
compression, the offline fused variant `Offline/OfflineSortformerDiarizer.
swift:215`: one pass per 30.72 s window, and `SortformerSpeakerStitcher`
identity matching across windows).

- `process`: a whole recording with streaming semantics. The chunk buffers
  (chunk count bucketed to a power of two, as JAX's jit cache does) go to
  the device in one copy; mel and encoder run batched over every chunk, the
  stateful transformer + cache update loops over the real chunks on the
  device with no host sync, and the predictions come back in one copy.
- `process_offline`: the recording goes to the device flat (int16 stays
  int16 until the device, halving the copy), the overlapping 30.72 s windows
  are cut there by reshape/slice, and mel + encoder + transformer run as one
  batched pass over all windows (bucketed to a power of two); the host
  stitches the windows' speaker slots (overlap correlation + Hungarian).
- `process_chunk` / `process_stream` / `enroll_speaker`: the live session,
  one chunk step per call.

On the card the stateful step is one CUDA graph per diarizer
(`models/sortformer.py::StepProgram`), replayed per chunk.

Weights: `checkpoint_dir` holds `encoder.npz`; `checkpoint_dir=None` reads
the model cache's `Repo.SORTFORMER` folder, as JAX does; with no checkpoint
the weights are seeded random (with a warning), drawn on `device`.
`device=None` is the GPU; pass "cpu" to run on the CPU. `set_mesh` takes
only None until the port has a mesh.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from fluidaudio_tpu_torch.diarizer.types import (
    DiarizationResult,
    PipelineTimings,
    TimedSpeakerSegment,
)
from fluidaudio_tpu_torch.models.sortformer import (
    FRAME_SECONDS,
    NUM_SPEAKERS,
    SORTFORMER_V2,
    SortformerConfig,
    SortformerModel,
    SortformerState,
    StepProgram,
    init_state,
    streaming_scan_program,
)
from fluidaudio_tpu_torch.models.zoo import disable_tf32, load_or_init
from fluidaudio_tpu_torch.ops.mel import MelConfig, MelFrontend
from fluidaudio_tpu_torch.parallel.mesh import axis_size, gather_rows, local_rows
from fluidaudio_tpu_torch.registry import DownloadUtils, Repo
from fluidaudio_tpu_torch.utils.device import resolve_device
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("diarizer.sortformer")

SAMPLE_RATE = 16_000
OFFLINE_WINDOW_MEL = 3072  # 30.72 s per fused window


class SortformerDiarizer:
    def __init__(
        self,
        config: SortformerConfig | None = None,
        *,
        threshold: float = 0.5,
        checkpoint_dir: str | Path | None = None,
        rng_seed: int = 0,
        device: torch.device | str | None = None,
    ):
        self.cfg = config or SORTFORMER_V2
        self.threshold = threshold
        self.device = resolve_device(device)
        disable_tf32()
        self.model = SortformerModel(self.cfg, device=self.device).eval()
        self.mel = MelFrontend(MelConfig(n_mels=self.cfg.n_mels, normalize=None),
                               device=self.device)
        base = Path(checkpoint_dir) if checkpoint_dir else DownloadUtils.repo_dir(Repo.SORTFORMER)
        load_or_init(self.model, base / "encoder.npz", rng_seed, self.device, "sortformer")
        # the stateful step of `process` and the live chunks: a CUDA graph on the card
        self._step = StepProgram(self.model, self.cfg)
        # persistent streaming session: the spkcache/FIFO state carries
        # enrolled-speaker identity across calls (ref enrollSpeaker,
        # `SortformerDiarizer.swift:225-380`)
        self._session_state = self.make_state()
        self._session_frames = 0
        self._slot_names: dict[int, str] = {}
        self._mesh = None  # `set_mesh`

    def set_mesh(self, mesh) -> None:
        """Enable (or with None disable) mesh-sharded offline diarization:
        `process_offline`'s window batch (its bucket rounded up to a multiple
        of the mesh's "data" axis) splits over "data"; each rank runs mel,
        encoder and transformer on its windows (`offline_windows`, the same
        program) and the predictions are all-gathered, so every rank
        stitches the same segments. Every rank is given the same recording;
        parameters are replicated. Mirrors `AsrManager.set_mesh`."""
        self._mesh = mesh

    @torch.no_grad()
    def stream_program(self, chunk_audio: torch.Tensor, state: SortformerState,
                       n_steps: int | None = None) -> tuple[torch.Tensor, SortformerState]:
        """Raw chunk buffers [N, chunk_samples] on the device -> batched mel ->
        batched encoder -> the stateful step over the first `n_steps` chunks
        -> (preds [n_steps, chunk_frames, 4], state), all on the device."""
        mel, _ = self.mel(chunk_audio)  # [N, n_mels, T] rows independent
        mel = mel[:, :, : self.cfg.chunk_frames * 8]
        return streaming_scan_program(self.model, mel, state, self.cfg, n_steps, self._step)

    @torch.no_grad()
    def offline_windows(self, flat: torch.Tensor, n_windows: int, step: int,
                        window_samples: int) -> torch.Tensor:
        """FLAT audio [(n_windows+1)*step] on the device (f32, or int16 PCM)
        -> overlapped windows by reshape/slice -> batched mel -> one
        encoder+transformer pass -> preds [n_windows, 384, 4]."""
        overlap = window_samples - step
        x = flat.float()
        if not flat.is_floating_point():
            x = x / 32768.0
        base = x[: n_windows * step].reshape(n_windows, step)
        tails = x[step : (n_windows + 1) * step].reshape(n_windows, step)[:, :overlap]
        mel, _ = self.mel(torch.cat([base, tails], dim=1))
        return self.model(mel[:, :, :OFFLINE_WINDOW_MEL])

    # -------------------------------------------------------------- streaming

    def make_state(self, batch: int = 1) -> SortformerState:
        return init_state(self.cfg, batch, self.device)

    # ------------------------------------------------------------- enrollment

    @property
    def speaker_names(self) -> dict[int, str]:
        return dict(self._slot_names)

    def reset_session(self) -> None:
        """Clear the persistent streaming state AND enrolled identities."""
        self._session_state = self.make_state()
        self._session_frames = 0
        self._slot_names = {}

    def enroll_speaker(
        self,
        samples: np.ndarray,
        name: str | None = None,
        overwrite_assigned_name: bool = True,
    ) -> str | None:
        """Prime the spkcache with a known speaker's audio and name the slot
        the model assigns it (ref `SortformerDiarizer.swift:225-380`).

        The enrollment audio flows through the normal streaming path so the
        speaker cache retains the identity; the frame clock resets so
        subsequent streaming starts at time zero. Returns the assigned name,
        or None when there isn't at least one full chunk of audio, no slot
        shows speech, or the best slot is already named and
        `overwrite_assigned_name` is False.
        """
        samples = np.asarray(samples, np.float32).reshape(-1)
        chunk_samples = self.cfg.chunk_frames * 1280
        if samples.size < chunk_samples:
            logger.warning(
                "enroll: need >= %.2f s of audio, got %.2f s",
                chunk_samples / SAMPLE_RATE, samples.size / SAMPLE_RATE,
            )
            return None
        speech_frames = np.zeros(NUM_SPEAKERS, np.int64)
        for start in range(0, samples.size - chunk_samples + 1, chunk_samples):
            preds, self._session_state = self.process_chunk(
                samples[start : start + chunk_samples], self._session_state
            )
            speech_frames += (preds >= self.threshold).sum(axis=0)
        best = int(np.argmax(speech_frames))
        if speech_frames[best] == 0:
            logger.warning("enroll: no speech detected — speaker not enrolled")
            self._session_frames = 0
            return None
        if best in self._slot_names and not overwrite_assigned_name:
            logger.warning(
                "enroll: diarizer matched existing speaker %r at slot %d and "
                "overwrite_assigned_name=False", self._slot_names[best], best,
            )
            self._session_frames = 0
            return None
        assigned = name or f"Speaker {best + 1}"
        self._slot_names[best] = assigned
        self._session_frames = 0
        return assigned

    def process_stream(self, samples: np.ndarray) -> DiarizationResult:
        """Streaming pass that CONTINUES the persistent session (state +
        enrolled names + frame clock), unlike `process` which is
        one-shot-per-recording."""
        t0 = time.perf_counter()
        samples = np.asarray(samples, np.float32).reshape(-1)
        chunk_samples = self.cfg.chunk_frames * 1280
        preds_list = []
        for start in range(0, max(1, samples.size), chunk_samples):
            preds, self._session_state = self.process_chunk(
                samples[start : start + chunk_samples], self._session_state
            )
            preds_list.append(preds)
            if start + chunk_samples >= samples.size:
                break
        preds = (
            np.concatenate(preds_list)
            if preds_list
            else np.zeros((0, NUM_SPEAKERS), np.float32)
        )
        n_frames = min(len(preds), int(np.ceil(samples.size / 1280)))
        segments = self._preds_to_segments(
            preds[:n_frames],
            names=self._slot_names,
            frame_offset=self._session_frames,
        )
        self._session_frames += n_frames
        return DiarizationResult(
            segments=segments,
            speaker_count=len({s.speaker_id for s in segments}),
            timings=PipelineTimings(total_seconds=time.perf_counter() - t0),
        )

    @torch.no_grad()
    def process_chunk(
        self, samples: np.ndarray, state: SortformerState
    ) -> tuple[np.ndarray, SortformerState]:
        """samples [chunk_frames*1280] -> (preds [chunk_frames, 4], state')."""
        need = self.cfg.chunk_frames * 1280
        buf = np.zeros(need, np.float32)
        buf[: min(len(samples), need)] = samples[:need]
        preds, state = self.stream_program(torch.from_numpy(buf)[None].to(self.device), state)
        return preds[0].cpu().numpy(), state

    def process(self, samples: np.ndarray) -> DiarizationResult:
        """Streaming-semantics pass over a whole recording with one copy each
        way: all chunks' mel + encoder run batched, the stateful transformer/
        cache updates loop on the device (chunk counts bucketed to powers of
        two; the loop stops at the last real chunk, the step being causal)."""
        t0 = time.perf_counter()
        samples = np.asarray(samples, np.float32).reshape(-1)
        chunk_samples = self.cfg.chunk_frames * 1280
        n_chunks = max(1, -(-samples.size // chunk_samples))
        bucket = 1 << (n_chunks - 1).bit_length()
        buf = np.zeros((bucket, chunk_samples), np.float32)
        flat = buf.reshape(-1)
        flat[: samples.size] = samples
        preds, _ = self.stream_program(torch.from_numpy(buf).to(self.device),
                                       self.make_state(), n_chunks)
        preds = preds.cpu().numpy().reshape(-1, NUM_SPEAKERS)
        n_frames = min(n_chunks * self.cfg.chunk_frames,
                       int(np.ceil(samples.size / 1280)))
        segments = self._preds_to_segments(preds[:n_frames])
        timings = PipelineTimings(total_seconds=time.perf_counter() - t0)
        return DiarizationResult(
            segments=segments,
            speaker_count=len({s.speaker_id for s in segments}),
            timings=timings,
        )

    # ---------------------------------------------------------------- offline

    def process_offline(self, samples: np.ndarray) -> DiarizationResult:
        """Fused 30.72 s windows + speaker stitching across windows: ALL of a
        recording's windows run as one batched device pass (window count
        bucketed to powers of two) instead of the reference's two CoreML
        dispatches per window (`OfflineSortformerDiarizer.swift:215`)."""
        t0 = time.perf_counter()
        samples = np.asarray(samples).reshape(-1)
        if samples.dtype not in (np.float32, np.int16):
            samples = samples.astype(np.float32)
        window_samples = OFFLINE_WINDOW_MEL * 160
        overlap_frames = 64  # ~5 s of 80 ms frames for identity matching
        step = window_samples - overlap_frames * 1280

        starts: list[int] = []
        sizes: list[int] = []
        for start in range(0, max(1, samples.size), max(1, step)):
            seg_size = max(0, min(samples.size - start, window_samples))
            if seg_size < 16000 and starts:
                break
            starts.append(start)
            sizes.append(seg_size)
            if start + window_samples >= samples.size:
                break

        W = len(starts)
        bucket = 1 << (W - 1).bit_length()
        rows = slice(0, bucket)
        if self._mesh is not None:
            n_data = axis_size(self._mesh, "data")
            bucket = -(-bucket // n_data) * n_data
            rows = local_rows(self._mesh, bucket)
        flat = np.zeros((bucket + 1) * step, samples.dtype)
        flat[: min(samples.size, flat.size)] = samples[: flat.size]
        # windows rows.start .. rows.stop - 1 read flat[start * step : (stop + 1) * step]
        mine = torch.from_numpy(flat[rows.start * step:(rows.stop + 1) * step]).to(self.device)
        preds = self.offline_windows(mine, rows.stop - rows.start, step, window_samples)
        if self._mesh is not None:
            preds = gather_rows(self._mesh, preds)
        preds_all = preds.cpu().numpy()

        windows = []
        for i, (start, size) in enumerate(zip(starts, sizes)):
            n_valid = min(preds_all.shape[1], int(np.ceil(size / 1280)))
            windows.append((start // 1280, preds_all[i, :n_valid]))

        stitched = self._stitch(windows)
        segments = self._preds_to_segments(stitched)
        timings = PipelineTimings(total_seconds=time.perf_counter() - t0)
        return DiarizationResult(
            segments=segments,
            speaker_count=len({s.speaker_id for s in segments}),
            timings=timings,
        )

    def _stitch(self, windows: list[tuple[int, np.ndarray]]) -> np.ndarray:
        """Permute each window's speaker slots to match the accumulated
        timeline via overlap correlation + Hungarian (SpeakerStitcher)."""
        if not windows:
            return np.zeros((0, NUM_SPEAKERS), np.float32)
        total_frames = max(off + len(p) for off, p in windows)
        acc = np.zeros((total_frames, NUM_SPEAKERS), np.float32)
        count = np.zeros(total_frames, np.float32)
        for off, preds in windows:
            end = off + len(preds)
            overlap = count[off:end] > 0
            if overlap.any():
                a = acc[off:end][overlap] / count[off:end][overlap][:, None]
                b = preds[overlap]
                corr = a.T @ b  # [4, 4]
                rows, cols = linear_sum_assignment(-corr)
                perm = np.zeros(NUM_SPEAKERS, np.int64)
                perm[rows] = cols
                preds = preds[:, perm]
            acc[off:end] += preds
            count[off:end] += 1.0
        return acc / np.maximum(count[:, None], 1.0)

    # ------------------------------------------------------------------ utils

    def _preds_to_segments(
        self,
        preds: np.ndarray,
        names: dict[int, str] | None = None,
        frame_offset: int = 0,
    ) -> list[TimedSpeakerSegment]:
        segments: list[TimedSpeakerSegment] = []
        names = names or {}
        T = len(preds)
        for s in range(NUM_SPEAKERS):
            active = preds[:, s] >= self.threshold
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
