"""Online streaming diarizer (pyannote-style pipeline), in PyTorch.

Port of `fluidaudio_tpu/diarizer/manager.py` (reference
`Diarizer/Core/DiarizerManager.swift:6,24-36,280-478`): 10 s chunks ->
segmentation powerset -> argmax binarization -> clean-frame masks (exclude
overlap: speakerSum < 2) -> masked speaker embeddings -> online
nearest-centroid assignment with dual thresholds (assign 1.2x, update 0.8x
of clustering threshold 0.7) -> per-speaker segment extraction with
overlap-aware dynamic threshold 0.3/0.15 and min-duration filtering.
Speaker enrollment via `initialize_known_speakers` +
`extract_speaker_embedding` (all-ones mask).

Per 10 s chunk the segmentation and the embedding (the 3 speaker masks on
the leading axis) each run on the device and come back to the host, where
the online `SpeakerManager` assigns speakers in order.

Weights: `checkpoint_dir` holds `segmentation.npz` and `embedding.npz`;
`checkpoint_dir=None` reads the model cache's `Repo.DIARIZER` folder, as JAX
does; a missing checkpoint leaves seeded random weights (with a warning)
drawn on `device`. `device=None` is the GPU; pass "cpu" to run on the CPU.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from fluidaudio_tpu_torch.diarizer.speaker_manager import SpeakerManager
from fluidaudio_tpu_torch.diarizer.types import (
    DiarizationResult,
    DiarizerConfig,
    PipelineTimings,
    Speaker,
    TimedSpeakerSegment,
    l2_normalize,
)
from fluidaudio_tpu_torch.models.pyannote_seg import (
    NUM_FRAMES,
    NUM_SPEAKERS,
    WINDOW_SAMPLES,
    PyannoteSegmentation,
    powerset_to_binary,
)
from fluidaudio_tpu_torch.models.wespeaker import WeSpeakerEmbedder, make_fbank_frontend
from fluidaudio_tpu_torch.models.zoo import disable_tf32, load_or_init
from fluidaudio_tpu_torch.registry import DownloadUtils, Repo
from fluidaudio_tpu_torch.utils.device import resolve_device
from fluidaudio_tpu_torch.utils.logging import get_logger

logger = get_logger("diarizer")

FRAME_STEP_SECONDS = 0.016875  # pyannote model step size (DiarizerManager.swift)


class DiarizerManager:
    def __init__(
        self,
        config: DiarizerConfig | None = None,
        *,
        checkpoint_dir: str | Path | None = None,
        rng_seed: int = 0,
        segmentation_arch: str = "attention",
        seg_config=None,
        emb_config=None,
        device: torch.device | str | None = None,
    ):
        """`seg_config` / `emb_config` override the model sizes (default:
        the full pyannote/WeSpeaker shapes the reference ships; the trained
        tiny fixtures pass the same reduced configs as the offline manager,
        so one segmentation/embedding checkpoint serves both pipelines —
        exactly the reference's model sharing between `DiarizerManager` and
        `OfflineDiarizerManager`)."""
        self.config = config or DiarizerConfig()
        c = self.config
        emb_dim = emb_config.embedding_dim if emb_config else 256
        self.speaker_manager = SpeakerManager(
            speaker_threshold=c.clustering_threshold * 1.2,
            embedding_threshold=c.clustering_threshold * 0.8,
            min_speech_duration=c.min_speech_duration,
            min_embedding_update_duration=c.min_embedding_update_duration,
            embedding_size=emb_dim,
        )
        # "attention": the parallel-context redesign; "pyannet": upstream-exact
        # PyanNet, loadable from converted pyannote/segmentation-3.0 checkpoints
        self.device = resolve_device(device)
        disable_tf32()
        if segmentation_arch == "pyannet":
            from fluidaudio_tpu_torch.models.pyannote_seg import PyanNet

            self.segmentation = PyanNet(device=self.device)
        else:
            self.segmentation = PyannoteSegmentation(*(seg_config,) if seg_config else (),
                                                     device=self.device)
        self.segmentation.eval()
        self.embedder = WeSpeakerEmbedder(*(emb_config,) if emb_config else (),
                                          device=self.device).eval()
        self.fbank = make_fbank_frontend(self.device)
        base = Path(checkpoint_dir) if checkpoint_dir else DownloadUtils.repo_dir(Repo.DIARIZER)
        load_or_init(self.segmentation, base / "segmentation.npz", rng_seed, self.device,
                     "diarizer segmentation")
        load_or_init(self.embedder, base / "embedding.npz", rng_seed + 1, self.device,
                     "diarizer embedding")

    @torch.no_grad()
    def _segment(self, padded: np.ndarray) -> np.ndarray:
        """padded [160000] -> binary [589, 3] on the host."""
        w = torch.from_numpy(padded)[None].to(self.device)
        return powerset_to_binary(self.segmentation(w))[0].cpu().numpy()

    @torch.no_grad()
    def _embed(self, padded: np.ndarray, masks: np.ndarray) -> np.ndarray:
        """waveform [160000], masks [S, T_frames] -> [S, D] on the host."""
        mel, _ = self.fbank(torch.from_numpy(padded)[None].to(self.device))  # [1, 80, T]
        mel_t = mel.transpose(1, 2)
        S = masks.shape[0]
        mel_rep = mel_t.expand(S, mel_t.shape[1], mel_t.shape[2])
        return self.embedder(mel_rep, torch.from_numpy(masks).to(self.device)).cpu().numpy()

    # ---------------------------------------------------------------- public

    def process(self, samples: np.ndarray) -> DiarizationResult:
        """Full-utterance diarization via sequential 10 s chunk processing."""
        t_total = time.perf_counter()
        samples = np.asarray(samples, np.float32).reshape(-1)
        # the segmentation model consumes fixed 10 s windows: larger
        # configured chunks would be silently truncated at WINDOW_SAMPLES
        chunk = min(int(self.config.chunk_duration * 16000), WINDOW_SAMPLES)
        step = chunk - int(self.config.chunk_overlap * 16000)
        if step <= 0:
            raise ValueError(
                f"chunk_overlap ({self.config.chunk_overlap}s) must be smaller "
                f"than the effective chunk duration ({chunk / 16000:.1f}s)"
            )
        timings = PipelineTimings()
        segments: list[TimedSpeakerSegment] = []
        for start in range(0, max(1, samples.size), step):
            part = samples[start : start + chunk]
            if part.size < 16000:  # skip sub-second tails
                break
            seg, chunk_t = self._process_chunk(part, start / 16000.0)
            segments.extend(seg)
            timings.segmentation_seconds += chunk_t[0]
            timings.embedding_seconds += chunk_t[1]
            timings.clustering_seconds += chunk_t[2]
        segments.sort(key=lambda s: s.start_time)
        segments = self._merge_adjacent(segments)
        timings.total_seconds = time.perf_counter() - t_total
        return DiarizationResult(
            segments=segments,
            speaker_count=self.speaker_manager.speaker_count,
            timings=timings,
        )

    def _process_chunk(
        self, chunk: np.ndarray, offset_seconds: float
    ) -> tuple[list[TimedSpeakerSegment], tuple[float, float, float]]:
        padded = np.zeros(WINDOW_SAMPLES, np.float32)
        padded[: chunk.size] = chunk[:WINDOW_SAMPLES]

        t0 = time.perf_counter()
        binary = self._segment(padded)
        t_seg = time.perf_counter() - t0  # [589, 3]

        # clean-frame masks: zero overlap frames
        t0 = time.perf_counter()
        speaker_sum = binary.sum(axis=-1)
        clean = (speaker_sum < 2.0).astype(np.float32)
        masks = (binary * clean[:, None]).T  # [3, 589]
        embeddings = self._embed(padded, np.ascontiguousarray(masks, np.float32))
        t_emb = time.perf_counter() - t0

        t0 = time.perf_counter()
        activities = binary.sum(axis=0)  # frames per speaker slot
        speaker_ids: list[str] = []
        for s in range(NUM_SPEAKERS):
            if activities[s] > self.config.min_active_frames_count and self._valid_embedding(
                embeddings[s]
            ):
                duration = float(activities[s]) * FRAME_STEP_SECONDS
                quality = self._embedding_quality(embeddings[s]) * (
                    activities[s] / binary.shape[0]
                )
                spk = self.speaker_manager.assign_speaker(
                    embeddings[s], speech_duration=duration, confidence=quality
                )
                speaker_ids.append(spk.id if spk else "")
            else:
                speaker_ids.append("")
        segments = self._timed_segments(binary, offset_seconds, embeddings, speaker_ids, activities)
        t_clu = time.perf_counter() - t0
        return segments, (t_seg, t_emb, t_clu)

    @staticmethod
    def _valid_embedding(e: np.ndarray) -> bool:
        return bool(np.all(np.isfinite(e)) and np.linalg.norm(e) > 0.1)

    @staticmethod
    def _embedding_quality(e: np.ndarray) -> float:
        norm = float(np.linalg.norm(e))
        return min(1.0, norm / 10.0 + 0.5)

    def _timed_segments(
        self,
        binary: np.ndarray,
        offset_seconds: float,
        embeddings: np.ndarray,
        speaker_ids: list[str],
        activities: np.ndarray,
    ) -> list[TimedSpeakerSegment]:
        num_frames, num_speakers = binary.shape
        out: list[TimedSpeakerSegment] = []
        for s in range(num_speakers):
            if activities[s] < self.config.min_active_frames_count or not speaker_ids[s]:
                continue
            active = False
            start_frame = 0
            for f in range(num_frames):
                other_active = any(
                    binary[f, o] > 0.3 for o in range(num_speakers) if o != s
                )
                threshold = 0.15 if other_active else 0.3
                if binary[f, s] > threshold and not active:
                    active = True
                    start_frame = f
                elif binary[f, s] <= threshold and active:
                    self._append_if_valid(out, s, start_frame, f, offset_seconds,
                                          embeddings, speaker_ids)
                    active = False
            if active:
                self._append_if_valid(out, s, start_frame, num_frames, offset_seconds,
                                      embeddings, speaker_ids)
        out.sort(key=lambda x: x.start_time)
        return out

    def _append_if_valid(
        self, out, s, start_frame, end_frame, offset, embeddings, speaker_ids
    ) -> None:
        start = offset + start_frame * FRAME_STEP_SECONDS
        end = offset + end_frame * FRAME_STEP_SECONDS
        if end - start >= self.config.min_speech_duration:
            out.append(
                TimedSpeakerSegment(
                    speaker_id=speaker_ids[s],
                    start_time=start,
                    end_time=end,
                    embedding=embeddings[s],
                )
            )

    def _merge_adjacent(self, segments: list[TimedSpeakerSegment]) -> list[TimedSpeakerSegment]:
        """Merge same-speaker segments separated by < min_silence_gap."""
        out: list[TimedSpeakerSegment] = []
        for seg in segments:
            if (
                out
                and out[-1].speaker_id == seg.speaker_id
                and seg.start_time - out[-1].end_time < self.config.min_silence_gap
            ):
                out[-1] = TimedSpeakerSegment(
                    speaker_id=seg.speaker_id,
                    start_time=out[-1].start_time,
                    end_time=max(out[-1].end_time, seg.end_time),
                    quality_score=out[-1].quality_score,
                    embedding=out[-1].embedding,
                )
            else:
                out.append(seg)
        return out

    # ------------------------------------------------ protocol-parity methods
    # (reference DiarizerProtocol.swift:6: addAudio/process/processComplete/
    #  enrollSpeaker/finalizeSession/reset/cleanup)

    def add_audio(self, samples: np.ndarray) -> None:
        """Accumulate audio for a later `process_complete` call."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        buf = getattr(self, "_pending", None)
        self._pending = samples if buf is None else np.concatenate([buf, samples])

    def process_complete(self) -> DiarizationResult:
        """Diarize everything accumulated via `add_audio`."""
        pending = getattr(self, "_pending", None)
        self._pending = None
        if pending is None or pending.size == 0:
            return DiarizationResult(segments=[], speaker_count=0)
        return self.process(pending)

    def finalize_session(self) -> DiarizationResult:
        result = self.process_complete()
        return result

    def reset(self) -> None:
        self._pending = None
        self.speaker_manager.reset(keep_if_permanent=True)

    def cleanup(self) -> None:
        self.reset()
        self.speaker_manager.reset(keep_if_permanent=False)

    # -------------------------------------------------------------- enrollment

    def extract_speaker_embedding(self, samples: np.ndarray) -> np.ndarray:
        """Embedding of a (single-speaker) sample via an all-ones mask
        (reference `DiarizerManager.swift:74-119`)."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        padded = np.zeros(WINDOW_SAMPLES, np.float32)
        padded[: min(samples.size, WINDOW_SAMPLES)] = samples[:WINDOW_SAMPLES]
        mask = np.zeros((1, NUM_FRAMES), np.float32)
        valid_frames = min(NUM_FRAMES, int(samples.size / 16000.0 / FRAME_STEP_SECONDS))
        mask[0, :valid_frames] = 1.0
        emb = self._embed(padded, mask)[0]
        return l2_normalize(emb)

    def enroll_speaker(self, samples: np.ndarray, speaker_id: str, name: str | None = None) -> None:
        emb = self.extract_speaker_embedding(samples)
        spk = Speaker(
            id=speaker_id,
            name=name or speaker_id,
            current_embedding=emb,
            duration=float(np.size(samples)) / 16000.0,
        )
        self.speaker_manager.initialize_known_speakers([spk], mode="overwrite")
