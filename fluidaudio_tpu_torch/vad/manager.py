"""VadManager: Silero VAD public API.

Behavioral parity: reference `VAD/VadManager.swift:14-30,162-330,352-376` —
4096-sample (256 ms) chunks with 64-sample carried context, repeat-last-sample
padding of the final partial chunk, LSTM h/c threaded sequentially; plus
`+SpeechSegmentation` (hysteresis machine) and `+Streaming` (state-in/state-out
events, deliberately not an async stream).

Port of `fluidaudio_tpu/vad/manager.py`: a whole utterance — or a batch of
utterances (`process_batch`) — is one run of `vad_frame_program` on the
device: the conv encoder runs batched over every 32 ms frame at once, only
the 128-d LSTM cell runs per frame, and its input projection and the sigmoid
head are batched around it. Frame counts are bucketed (powers of two) and
one `FrameProgram` is kept per (batch, bucket, input dtype), a CUDA graph on
the card, as JAX keeps one jitted program per shape. Unlike a jitted program
a graph holds device buffers, so the graphs of one manager share one memory
pool and one warm-up stream, and at most `PROGRAM_CACHE_SIZE` are kept, the
least recently used going first. int16 rows stay int16
until the upcast on the device. One device->host copy brings the
probabilities and the final states back.

Weights: `checkpoint_dir` holds `silero_vad.npz`; `checkpoint_dir=None`
reads the model cache's `Repo.VAD` folder, as JAX does; with no checkpoint
the weights are seeded random (with a warning), drawn on `device`.
`device=None` is the GPU; pass "cpu" to run on the CPU. `set_mesh(None)` is
a no-op; a mesh raises NotImplementedError (torch.distributed serving is
ROADMAP Queue A item 7).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from fluidaudio_tpu_torch.models.silero_vad import FrameProgram, SileroV5Config, SileroVadV5
from fluidaudio_tpu_torch.models.zoo import disable_tf32, load_or_init
from fluidaudio_tpu_torch.parallel.mesh import axis_size, gather_rows, local_rows
from fluidaudio_tpu_torch.registry import DownloadUtils, Repo
from fluidaudio_tpu_torch.utils.device import resolve_device
from fluidaudio_tpu_torch.vad.segmentation import detect_speech_sample_ranges, segments_from_ranges
from fluidaudio_tpu_torch.vad.types import (
    CHUNK_SIZE,
    CONTEXT_SIZE,
    SAMPLE_RATE,
    STATE_SIZE,
    VadConfig,
    VadResult,
    VadSegment,
    VadSegmentationConfig,
    VadState,
    VadStreamEvent,
    VadStreamResult,
    VadStreamState,
)

FRAME_SIZE = 512  # 32 ms model frames; 8 per 256 ms public chunk
FRAMES_PER_CHUNK = CHUNK_SIZE // FRAME_SIZE
PROGRAM_CACHE_SIZE = 8  # frame programs (CUDA graphs on the card) kept per manager


def _coerce_samples(samples) -> np.ndarray:
    """f32 passthrough; int16 preserved for the on-device PCM upcast (half
    the host->device bytes); everything else coerced to f32. Non-finite
    samples are sanitized (NaN -> 0, ±inf -> ±1) so probabilities stay
    finite (ref VadTests testVadWithNaNAndInfinity)."""
    arr = np.asarray(samples)
    if arr.dtype not in (np.float32, np.int16):
        arr = arr.astype(np.float32)
    arr = arr.reshape(-1)
    if arr.dtype == np.float32 and not np.isfinite(arr).all():
        arr = np.nan_to_num(arr, nan=0.0, posinf=1.0, neginf=-1.0)
    return arr


class VadManager:
    def __init__(
        self,
        config: VadConfig | None = None,
        *,
        skip_model_loading: bool = False,
        checkpoint_dir: str | Path | None = None,
        rng_seed: int = 0,
        device: torch.device | str | None = None,
    ):
        """`skip_model_loading=True` builds a logic-only manager for testing the
        segmentation/streaming machines (reference `VadManager(skipModelLoading:)`);
        it needs no device."""
        self.config = config or VadConfig()
        self.model_cfg = SileroV5Config()
        self.model: SileroVadV5 | None = None
        self.device: torch.device | None = None
        self._program_cache: OrderedDict[tuple[int, int, str], FrameProgram] = OrderedDict()
        self._graph_pool = None  # the CUDA graph memory pool of every frame program
        self._warmup_stream: torch.cuda.Stream | None = None  # and their warm-up stream
        self._mesh = None  # `set_mesh`
        if not skip_model_loading:
            self._load_params(checkpoint_dir, rng_seed, device)

    def set_mesh(self, mesh) -> None:
        """Enable (or with None disable) mesh-sharded batch VAD: each
        `_run_batch` pads the utterance batch up to a multiple of the mesh's
        "data" axis (zero rows, as JAX pads), each rank runs its rows through
        the same frame program (a CUDA graph on the card) and the outputs are
        all-gathered over "data". Every rank is given the same request;
        parameters are replicated (each rank holds the whole model).
        Mirrors `AsrManager.set_mesh`."""
        if mesh is not None:
            assert self.model is not None, "model not loaded (skip_model_loading)"
        self._mesh = mesh

    def _load_params(self, checkpoint_dir: str | Path | None, rng_seed: int,
                     device) -> None:
        self.device = resolve_device(device)
        disable_tf32()
        self.model = SileroVadV5(self.model_cfg, device=self.device).eval()
        base = Path(checkpoint_dir) if checkpoint_dir else DownloadUtils.repo_dir(Repo.VAD)
        load_or_init(self.model, base / "silero_vad.npz", rng_seed, self.device, "VAD")

    # ----------------------------------------------------------------- device

    def _frame_program(self, batch: int, n_frames: int, dtype) -> FrameProgram:
        """The whole-utterance program for fixed [batch, n_frames] and input dtype."""
        key = (batch, n_frames, np.dtype(dtype).name)
        if key in self._program_cache:
            self._program_cache.move_to_end(key)
            return self._program_cache[key]
        if self.device.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._warmup_stream = torch.cuda.Stream(self.device)
        while len(self._program_cache) >= PROGRAM_CACHE_SIZE:
            self._program_cache.popitem(last=False)
        program = self._program_cache[key] = FrameProgram(
            self.model, pool=self._graph_pool, stream=self._warmup_stream)
        return program

    # ------------------------------------------------------------------- API

    @staticmethod
    def _pad_chunks(samples: np.ndarray) -> np.ndarray:
        """[n] -> flat [n_chunks * 4096], final partial chunk repeat-last
        padded; dtype-preserving (int16 rows stay int16 until the on-device
        upcast — half the host->device bytes for PCM sources)."""
        n = samples.shape[0]
        n_chunks = max(1, -(-n // CHUNK_SIZE))
        flat = np.empty(n_chunks * CHUNK_SIZE, samples.dtype)
        flat[:n] = samples
        if n < flat.size:
            flat[n:] = samples[-1] if n else 0
        return flat

    @staticmethod
    def _ctx_as(ctx: np.ndarray, dtype) -> np.ndarray:
        """Carried context -> the packed buffer's dtype (PCM scale 1/32768)."""
        if ctx.dtype == dtype:
            return ctx
        if np.issubdtype(dtype, np.integer):
            return np.clip(np.round(ctx * 32768.0), -32768, 32767).astype(dtype)
        return ctx.astype(np.float32) / 32768.0

    def _run_batch(
        self, rows: list[np.ndarray], states: list[VadState]
    ) -> tuple[np.ndarray, list[VadState]]:
        """Shared batch runner: rows = per-utterance raw samples (non-empty).

        Returns (chunk_probs [B, max_chunks] with NaN past each row's real
        chunks, final_states after each row's last real chunk)."""
        assert self.model is not None, "model not loaded (skip_model_loading)"
        flats = [self._pad_chunks(r) for r in rows]
        n_chunks = [f.size // CHUNK_SIZE for f in flats]
        # one bucket for the whole batch keeps it a single dispatch
        bucket = 1 << (max(n_chunks) - 1).bit_length()
        n_frames = bucket * FRAMES_PER_CHUNK
        B = len(rows)

        pack_dtype = (
            np.int16 if all(f.dtype == np.int16 for f in flats) else np.float32
        )
        audio = np.zeros((B, CONTEXT_SIZE + n_frames * FRAME_SIZE), pack_dtype)
        for b, (flat, st) in enumerate(zip(flats, states)):
            audio[b, :CONTEXT_SIZE] = self._ctx_as(np.asarray(st.context), pack_dtype)
            if flat.dtype == pack_dtype:
                audio[b, CONTEXT_SIZE : CONTEXT_SIZE + flat.size] = flat
            else:  # int16 row in a mixed (f32-packed) batch: PCM upcast here
                audio[b, CONTEXT_SIZE : CONTEXT_SIZE + flat.size] = (
                    flat.astype(np.float32) / 32768.0
                )
        h0 = np.stack([st.hidden_state for st in states]).astype(np.float32)
        c0 = np.stack([st.cell_state for st in states]).astype(np.float32)

        last_idx = np.asarray(
            [nc * FRAMES_PER_CHUNK - 1 for nc in n_chunks], np.int32
        )  # causal scan: pad tail can't leak back into the last real frame
        dev, rows = self.device, slice(0, B)
        if self._mesh is not None:
            # pad the utterance batch to the mesh's data axis, this rank's rows
            n_data = axis_size(self._mesh, "data")
            Bp = -(-B // n_data) * n_data
            if Bp != B:
                audio, h0, c0, last_idx = (
                    np.concatenate([x, np.zeros((Bp - B,) + x.shape[1:], x.dtype)])
                    for x in (audio, h0, c0, last_idx))
            rows = local_rows(self._mesh, Bp)
        fn = self._frame_program(rows.stop - rows.start, n_frames, pack_dtype)
        probs, h_fin, c_fin = fn(
            torch.from_numpy(audio[rows]).to(dev), torch.from_numpy(h0[rows]).to(dev),
            torch.from_numpy(c0[rows]).to(dev), torch.from_numpy(last_idx[rows]).to(dev),
        )
        out = torch.cat([probs, h_fin, c_fin], dim=1)
        if self._mesh is not None:
            out = gather_rows(self._mesh, out)[:B]
        host = out.cpu().numpy()  # one copy
        probs = host[:, :n_frames]
        h_fin = host[:, n_frames : n_frames + STATE_SIZE]
        c_fin = host[:, n_frames + STATE_SIZE :]

        chunk_probs = probs.reshape(B, bucket, FRAMES_PER_CHUNK).max(axis=2)
        finals = []
        for b, (flat, nc) in enumerate(zip(flats, n_chunks)):
            chunk_probs[b, nc:] = np.nan
            finals.append(VadState(h_fin[b], c_fin[b], flat[-CONTEXT_SIZE:].copy()))
        return chunk_probs, finals

    def process(
        self, samples: np.ndarray, input_state: VadState | None = None
    ) -> list[VadResult]:
        """Sequential state-threaded probabilities for each 256 ms chunk."""
        t0 = time.perf_counter()
        samples = _coerce_samples(samples)
        if samples.size == 0:
            return []
        state = input_state or VadState.initial()
        chunk_probs, finals = self._run_batch([samples], [state])
        probs = chunk_probs[0][~np.isnan(chunk_probs[0])]
        n = probs.size
        dt = (time.perf_counter() - t0) / max(1, n)

        results = []
        for i, p in enumerate(probs):
            st = finals[0] if i == n - 1 else state
            results.append(
                VadResult(
                    probability=float(p),
                    is_voice_active=float(p) >= self.config.default_threshold,
                    output_state=st,
                    processing_time=dt,
                )
            )
        return results

    def process_batch(
        self,
        utterances: list[np.ndarray],
        input_states: list[VadState] | None = None,
    ) -> list[list[VadResult]]:
        """Batch many utterances into ONE device dispatch (rows bucket-padded
        to the longest). The throughput path for benchmark/file workloads —
        per-call overhead and the LSTM scan amortize across all rows."""
        rows = [_coerce_samples(u) for u in utterances]
        states = input_states or [VadState.initial() for _ in rows]
        nonempty = [i for i, r in enumerate(rows) if r.size]
        out: list[list[VadResult]] = [[] for _ in rows]
        if not nonempty:
            return out
        t0 = time.perf_counter()
        chunk_probs, finals = self._run_batch(
            [rows[i] for i in nonempty], [states[i] for i in nonempty]
        )
        dt = time.perf_counter() - t0
        total_chunks = int(np.sum(~np.isnan(chunk_probs)))
        for j, i in enumerate(nonempty):
            probs = chunk_probs[j][~np.isnan(chunk_probs[j])]
            n = probs.size
            out[i] = [
                VadResult(
                    probability=float(p),
                    is_voice_active=float(p) >= self.config.default_threshold,
                    output_state=finals[j] if k == n - 1 else states[i],
                    processing_time=dt / max(1, total_chunks),
                )
                for k, p in enumerate(probs)
            ]
        return out

    def process_chunk(
        self, chunk: np.ndarray, input_state: VadState | None = None
    ) -> VadResult:
        assert self.model is not None, "model not loaded (skip_model_loading)"
        t0 = time.perf_counter()
        state = input_state or VadState.initial()
        chunk = _coerce_samples(chunk)
        if chunk.size < CHUNK_SIZE:
            pad_val = chunk[-1] if chunk.size else 0
            chunk = np.concatenate(
                [chunk, np.full(CHUNK_SIZE - chunk.size, pad_val, chunk.dtype)]
            )
        chunk = chunk[:CHUNK_SIZE]
        chunk_probs, finals = self._run_batch([chunk], [state])
        return VadResult(
            probability=float(chunk_probs[0, 0]),
            is_voice_active=float(chunk_probs[0, 0]) >= self.config.default_threshold,
            output_state=finals[0],
            processing_time=time.perf_counter() - t0,
        )

    # ----------------------------------------------------------- segmentation

    def segment_speech(
        self,
        samples: np.ndarray,
        config: VadSegmentationConfig | None = None,
        probabilities: list[float] | None = None,
    ) -> list[VadSegment]:
        config = config or VadSegmentationConfig()
        if probabilities is None:
            probabilities = [r.probability for r in self.process(samples)]
        if not probabilities:
            return []
        threshold = self._entry_threshold(config)
        ranges = detect_speech_sample_ranges(
            probabilities, int(np.size(samples)), threshold, config
        )
        return segments_from_ranges(ranges)

    def segment_speech_audio(
        self, samples: np.ndarray, config: VadSegmentationConfig | None = None
    ) -> list[np.ndarray]:
        samples = np.asarray(samples, np.float32).reshape(-1)
        return [
            samples[seg.start_sample() : seg.end_sample()]
            for seg in self.segment_speech(samples, config)
        ]

    def _entry_threshold(self, config: VadSegmentationConfig) -> float:
        if config.negative_threshold is not None:
            return min(1.0, config.negative_threshold + config.negative_threshold_offset)
        return self.config.default_threshold

    # -------------------------------------------------------------- streaming

    def make_stream_state(self) -> VadStreamState:
        return VadStreamState.initial()

    def process_streaming_chunk(
        self,
        chunk: np.ndarray,
        state: VadStreamState,
        config: VadSegmentationConfig | None = None,
        return_seconds: bool = False,
        time_resolution: int = 1,
    ) -> VadStreamResult:
        config = config or VadSegmentationConfig()
        result = self.process_chunk(chunk, state.model_state)
        return self.streaming_state_machine(
            probability=result.probability,
            chunk_sample_count=int(np.size(chunk)),
            model_state=result.output_state,
            state=state,
            config=config,
            return_seconds=return_seconds,
            time_resolution=time_resolution,
        )

    def streaming_state_machine(
        self,
        probability: float,
        chunk_sample_count: int,
        model_state: VadState,
        state: VadStreamState,
        config: VadSegmentationConfig,
        return_seconds: bool = False,
        time_resolution: int = 1,
    ) -> VadStreamResult:
        next_state = VadStreamState(
            model_state=model_state,
            triggered=state.triggered,
            processed_samples=state.processed_samples + chunk_sample_count,
            temp_end_sample=state.temp_end_sample,
        )
        threshold = self._entry_threshold(config)
        negative = config.effective_negative_threshold(threshold)
        pad = int(config.speech_padding * SAMPLE_RATE)
        min_silence = int(config.min_silence_duration * SAMPLE_RATE)

        event: VadStreamEvent | None = None
        if probability >= threshold:
            next_state.temp_end_sample = None
            if not next_state.triggered:
                next_state.triggered = True
                start = max(0, next_state.processed_samples - pad - chunk_sample_count)
                event = self._make_event("speech_start", start, return_seconds, time_resolution)
        elif probability < negative and next_state.triggered:
            if next_state.temp_end_sample is None:
                next_state.temp_end_sample = next_state.processed_samples
            if next_state.processed_samples - next_state.temp_end_sample >= min_silence:
                end = max(0, next_state.temp_end_sample + pad - chunk_sample_count)
                next_state.triggered = False
                next_state.temp_end_sample = None
                event = self._make_event("speech_end", end, return_seconds, time_resolution)

        return VadStreamResult(state=next_state, event=event, probability=probability)

    @staticmethod
    def _make_event(
        kind: str, sample_index: int, return_seconds: bool, time_resolution: int
    ) -> VadStreamEvent:
        sample_index = max(0, sample_index)
        if return_seconds:
            factor = 10.0**time_resolution
            seconds = round(sample_index / SAMPLE_RATE * factor) / factor
            return VadStreamEvent(kind, sample_index, seconds)
        return VadStreamEvent(kind, sample_index, None)
