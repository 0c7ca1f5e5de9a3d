"""AsrManager: public batch transcription API (Parakeet TDT family), PyTorch.

Port of `fluidaudio_tpu/asr/manager.py`: mel -> encoder -> TDT decode on the
models' device, single windows up to 15 s and chunked long-form audio
(`asr/chunk.py` windows stacked on the batch axis, then merged on the host).

Audio is padded into a small set of sample-width buckets and per-row valid
lengths mask the padding. int16 PCM is shipped to the device as int16 and
upcast there (half the host->device bytes).

`language=` (on `transcribe` and `build_pipeline`) enables decode-time
script filtering with the English blocklist (`utils/language.py`): a
[vocab+1] bool mask of allowed tokens, built once per language.

`warmup()` runs the long-form pipeline once before the first request.
`set_mesh(mesh)` shards each window group over the mesh's "data" axis
(`parallel/mesh.py`): each rank decodes its rows through the single-device
pipeline, then the outputs are all-gathered; `set_mesh(None)` keeps
single-device serving.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from fluidaudio_tpu_torch.asr.chunk import (
    ChunkProcessor,
    TokenWindow,
    case_variant_canonical_ids,
    splice_safe_token_ids,
)
from fluidaudio_tpu_torch.asr.config import ASRConfig, ASRResult, TokenTiming
from fluidaudio_tpu_torch.asr.constants import ASRConstants
from fluidaudio_tpu_torch.asr.sequence_matcher import remove_duplicate_token_sequence
from fluidaudio_tpu_torch.models.zoo import AsrModels
from fluidaudio_tpu_torch.ops.tdt_decode import (
    TdtDecodeConfig,
    TdtDecodeState,
    TdtResult,
    make_initial_state,
    tdt_greedy_decode,
)
from fluidaudio_tpu_torch.parallel.mesh import axis_size, gather_rows, local_rows
from fluidaudio_tpu_torch.utils.audio_source import (
    ArrayAudioSource,
    AudioSampleSource,
    make_audio_source,
)
from fluidaudio_tpu_torch.utils.converter import AudioConverter
from fluidaudio_tpu_torch.utils.language import TokenLanguageFilter
from fluidaudio_tpu_torch.utils.logging import get_logger
from fluidaudio_tpu_torch.utils.timing import ProgressEmitter

logger = get_logger("asr")

# short-audio sample-width buckets (seconds: 1, 2, 4, 8, 15)
_BUCKETS = (16_000, 32_000, 64_000, 128_000, 240_000)


def _copy_raw(source: AudioSampleSource, start: int, count: int) -> np.ndarray:
    """Dtype-preserving read; falls back to the f32 contract for custom
    sources that predate `copy_samples_raw`."""
    fn = getattr(source, "copy_samples_raw", None)
    return fn(start, count) if fn is not None else source.copy_samples(start, count)


class AsrManager:
    def __init__(self, models: AsrModels, config: ASRConfig | None = None):
        self.models = models
        self.config = config or ASRConfig()
        self.converter = AudioConverter()
        vocab = models.tokenizer.vocabulary
        self._splice_safe = splice_safe_token_ids(vocab)
        self._case_canon = case_variant_canonical_ids(vocab)
        # per-session progress stream for long transcriptions
        self.progress = ProgressEmitter()
        self._language_masks: dict[str, torch.Tensor] = {}
        self._mesh = None  # `set_mesh`

    def set_mesh(self, mesh) -> None:
        """Enable (or with None disable) mesh-sharded long-form decoding.

        Every rank is given the same request (SPMD). Each window group's rows
        split over the mesh's "data" axis: a rank runs its rows through the
        same single-device pipeline (`build_pipeline` at the group's batch
        over the axis: kernels and all), the decode outputs are all-gathered
        over "data", and every rank merges the whole group, as the
        single-device path does. Parameters are replicated: each rank holds
        the whole model. `parallel_chunk_batch` must be a multiple of the
        axis."""
        if mesh is None:
            self._mesh = None
            return
        n_data = axis_size(mesh, "data")
        if self.config.parallel_chunk_batch % n_data:
            raise ValueError(
                f"parallel_chunk_batch={self.config.parallel_chunk_batch} "
                f"must be a multiple of the mesh data axis ({n_data})"
            )
        self._mesh = mesh

    # ------------------------------------------------------------- pipeline

    @property
    def _decode_cfg(self) -> TdtDecodeConfig:
        tdt = self.config.tdt
        return TdtDecodeConfig(
            blank_id=self.models.blank_id,
            durations=tdt.durations,
            max_symbols_per_step=tdt.max_symbols_per_step,
            max_tokens=tdt.max_tokens_per_chunk,
            consecutive_blank_limit=tdt.consecutive_blank_limit,
        )

    def build_pipeline(self, batch: int, language: str | None = None,
                       stateful: bool = False) -> Callable:
        """Pipeline fn(audio [B, W], lengths [B], finalize=None) ->
        (TdtResult, encoder lengths), on the models' device. With
        `stateful=True`, fn(audio, lengths, decoder_state, finalize=None) so a
        caller-held carry continues across calls. `finalize` is an optional
        [B] bool mask of rows decoding their utterance's LAST chunk; those
        run the decoder's last-chunk flush. `language` enables decode-time
        script filtering + the English blocklist."""
        models = self.models
        dcfg = self._decode_cfg
        pcfg = models.spec.predictor
        device = models.device
        allowed_mask = self._language_mask(language) if language else None

        @torch.no_grad()
        def run(audio, lengths, state: TdtDecodeState, finalize=None):
            audio = torch.as_tensor(audio).to(device, non_blocking=True)
            lengths = torch.as_tensor(lengths).to(device=device, dtype=torch.int32)
            if not audio.is_floating_point():
                # int16 PCM shipped raw; upcast on device
                audio = audio.float() * (1.0 / 32768.0)
            mel, mel_len = models.mel(audio, lengths)
            enc_out, enc_len = models.encoder(mel, mel_len)
            if finalize is not None:
                finalize = torch.as_tensor(finalize).to(device)
            result = tdt_greedy_decode(
                dcfg, models.predictor, models.joint, enc_out, enc_len, state,
                allowed_mask=allowed_mask, finalize_mask=finalize,
            )
            return result, enc_len

        if stateful:
            return run

        def pipeline(audio, lengths, finalize=None):
            state = make_initial_state(dcfg, pcfg.n_layers, pcfg.pred_hidden, batch,
                                       dtype=pcfg.compute_dtype, device=device)
            return run(audio, lengths, state, finalize)

        return pipeline

    def warmup(self, batch: int | None = None, window_samples: int | None = None) -> None:
        """Run the long-form pipeline once on zeros before the first request
        (JAX `warmup`): on the GPU this builds the kernels and sets up the
        libraries, so the first request does not pay for it."""
        b = batch or self.config.parallel_chunk_batch
        cp = ChunkProcessor(ArrayAudioSource(np.zeros(1, np.float32)))
        w = window_samples or cp.chunk_layout(self.config.mel_chunk_context).window_samples
        audio = torch.zeros((b, w), dtype=torch.float32)
        lengths = torch.full((b,), w, dtype=torch.int32)
        self.build_pipeline(b)(audio, lengths, torch.zeros((b,), dtype=torch.bool))
        if self.models.device.type == "cuda":
            torch.cuda.synchronize(self.models.device)

    def _language_mask(self, language: str) -> torch.Tensor:
        """[vocab+1] bool on the models' device: tokens allowed for
        `language` (script match minus the English blocklist; the blank slot
        is ignored by the filter)."""
        if language not in self._language_masks:
            vocab = dict(self.models.tokenizer.vocabulary)  # {id: piece}
            filt = TokenLanguageFilter(language, vocab)
            n = self.models.blank_id + 1
            mask = np.zeros((n,), bool)
            for tid in filt.allowed:
                if tid < n:
                    mask[tid] = True
            self._language_masks[language] = torch.from_numpy(mask).to(self.models.device)
        return self._language_masks[language]

    # ------------------------------------------------------------ transcribe

    def transcribe(
        self,
        audio: np.ndarray | str | Path,
        sample_rate: int | None = None,
        language: str | None = None,
        decoder_state: TdtDecodeState | None = None,
        previous_tokens: list[int] | None = None,
        finalize: bool = True,
    ) -> ASRResult:
        """Transcribe an array or WAV file.

        `finalize=True` (the default: a single call is first and last chunk)
        runs the decoder's last-chunk flush; streaming callers decoding an
        intermediate window pass False. `language` enables decode-time script
        filtering (e.g. "en", "ru", "ja"). `decoder_state` carries TDT decoder
        state across calls (single-window path only); the updated state is
        returned on `ASRResult.decoder_state`. `previous_tokens` are the tail
        token IDs of the preceding sequential chunk: boundary-duplicated
        tokens are dropped from this result's head.
        """
        t_start = time.perf_counter()
        if isinstance(audio, (str, Path)):
            source = make_audio_source(
                audio, disk_backed_threshold=self.config.streaming_threshold
            )
        else:
            samples = np.asarray(audio)
            if samples.dtype != np.int16:  # int16 PCM rides raw to the device
                samples = samples.astype(np.float32)
            samples = samples.reshape(-1)
            if sample_rate and sample_rate != self.config.sample_rate:
                if samples.dtype == np.int16:
                    samples = samples.astype(np.float32) / 32768.0
                samples = self.converter.resample_buffer(samples, sample_rate)
            source = ArrayAudioSource(samples)

        n = source.sample_count
        duration = n / self.config.sample_rate
        if n < ASRConstants.minimum_required_samples():
            # echo the caller's carry unchanged — nothing was decoded
            result = ASRResult("", 0.0, duration, time.perf_counter() - t_start)
            result.decoder_state = decoder_state
            return result

        if n <= ASRConstants.MAX_MODEL_SAMPLES:
            tokens, final_state = self._transcribe_single(
                source, language, decoder_state, finalize)
        else:
            if decoder_state is not None:
                raise ValueError(
                    "decoder_state cannot be carried through the chunked "
                    f"long-form path (>{ASRConstants.MAX_MODEL_SAMPLES} "
                    "samples): windows decode in parallel with no sequential "
                    "carry. Split the audio yourself or drop decoder_state."
                )
            tokens, final_state = self._transcribe_chunked(source, language, finalize)

        if previous_tokens:
            _, removed = self.remove_duplicate_token_sequence(
                previous_tokens, [t.token for t in tokens]
            )
            tokens = tokens[removed:]
        tokens = ChunkProcessor(source).collapse_seam_word_duplicates(
            tokens, self.models.tokenizer.vocabulary
        )
        result = self._assemble_result(tokens, duration, t_start)
        result.decoder_state = final_state
        return result

    def _transcribe_single(
        self, source: AudioSampleSource, language: str | None = None,
        decoder_state: TdtDecodeState | None = None, finalize: bool = True,
    ) -> tuple[list[TokenWindow], TdtDecodeState]:
        n = source.sample_count
        width = next((b for b in _BUCKETS if b >= n), ASRConstants.MAX_MODEL_SAMPLES)
        audio = torch.from_numpy(_copy_raw(source, 0, width))[None, :]
        lengths = torch.tensor([n], dtype=torch.int32)
        fin = torch.tensor([finalize])
        if decoder_state is None:
            result, _ = self.build_pipeline(1, language)(audio, lengths, fin)
        else:
            # caller-held state: decode continues from the provided carry
            result, _ = self.build_pipeline(1, language, stateful=True)(
                audio, lengths, decoder_state, fin)
        return _extract_tokens(result, [0])[0], result.state

    def _transcribe_chunked(
        self, source: AudioSampleSource, language: str | None = None,
        finalize: bool = True,
    ) -> tuple[list[TokenWindow], None]:
        cp = ChunkProcessor(source)
        layout, windows = cp.plan_windows(
            mel_chunk_context=self.config.mel_chunk_context,
            model_version=self.models.spec.name,
            prefer_silence_alignment=self.config.prefer_silence_alignment,
        )
        B = self.config.parallel_chunk_batch
        W = layout.window_samples
        mesh = self._mesh
        rows = local_rows(mesh, B) if mesh is not None else slice(0, B)
        fn = self.build_pipeline(rows.stop - rows.start, language)

        merged: list[TokenWindow] = []
        n_groups = -(-len(windows) // B)
        pack_dtype = _copy_raw(source, 0, 0).dtype
        for i in range(0, len(windows), B):
            group = windows[i : i + B]
            audio = np.zeros((B, W), pack_dtype)
            lengths = np.zeros((B,), np.int32)
            fin_row = np.zeros((B,), bool)
            for r, w in enumerate(group):
                audio[r, : w.read_count] = _copy_raw(source, w.read_start, w.read_count)
                lengths[r] = w.read_count
                fin_row[r] = w.is_last and finalize  # last window runs the flush
            result, _ = fn(torch.from_numpy(audio[rows]), torch.from_numpy(lengths[rows]),
                           torch.from_numpy(fin_row[rows]))
            if mesh is not None:
                result = result._replace(**{
                    f: gather_rows(mesh, getattr(result, f))
                    for f in ("tokens", "token_times", "counts", "confidences", "durations")})
            for window_tokens in _extract_tokens(result, [w.frame_offset for w in group]):
                merged = cp.merge_chunks(
                    merged, window_tokens, self._splice_safe, self._case_canon
                )
            self.progress.emit((i // B + 1) / n_groups)
        self.progress.finish_session()
        return merged, None

    def remove_duplicate_token_sequence(
        self, previous: list[int], current: list[int], max_overlap: int = 12
    ) -> tuple[list[int], int]:
        """Boundary dedup between sequential chunks; see
        `sequence_matcher.remove_duplicate_token_sequence`."""
        return remove_duplicate_token_sequence(
            previous,
            current,
            punctuation_tokens=ASRConstants.PUNCTUATION_TOKENS,
            boundary_search_frames=self.config.tdt.boundary_search_frames,
            max_overlap=max_overlap,
        )

    def _assemble_result(
        self, tokens: list[TokenWindow], duration: float, t_start: float
    ) -> ASRResult:
        tok = self.models.tokenizer
        text = tok.decode([t.token for t in tokens])
        confidence = float(np.mean([t.confidence for t in tokens])) if tokens else 0.0
        spf = ASRConstants.SECONDS_PER_ENCODER_FRAME
        # TDT emission-delay correction: tokens surface ~1 encoder frame
        # after the acoustic event; TDT_EMISSION_DELAY_FRAMES overrides
        delay = int(os.environ.get("TDT_EMISSION_DELAY_FRAMES", "1"))
        ordered = sorted(tokens, key=lambda t: t.timestamp)
        timings = []
        for i, t in enumerate(ordered):
            start = max(0, t.timestamp - delay) * spf
            if t.duration > 0:
                end = start + max(t.duration * spf, spf)
            elif i < len(ordered) - 1:
                nxt = max(0, ordered[i + 1].timestamp - delay) * spf
                end = max(nxt, start + spf)
            else:
                end = start + spf
            timings.append(
                TokenTiming(
                    token=tok.piece(t.token).replace(
                        ASRConstants.SENTENCEPIECE_WORD_BOUNDARY, " "
                    ),
                    token_id=t.token,
                    start_time=start,
                    end_time=max(end, start + 0.001),
                    confidence=t.confidence,
                )
            )
        return ASRResult(
            text=text,
            confidence=confidence,
            duration=duration,
            processing_time=time.perf_counter() - t_start,
            token_timings=timings,
        )


def _extract_tokens(result: TdtResult, frame_offsets: list[int]) -> list[list[TokenWindow]]:
    """Rows 0..len(frame_offsets)-1 of a decode result -> token windows, with
    one device->host copy per field for the whole batch."""
    n = len(frame_offsets)
    counts = result.counts[:n].cpu().numpy()
    ids = result.tokens[:n].cpu().numpy()
    times = result.token_times[:n].cpu().numpy()
    confs = result.confidences[:n].cpu().numpy()
    durs = result.durations[:n].cpu().numpy()
    out = []
    for r, offset in enumerate(frame_offsets):
        c = int(counts[r])
        out.append([
            TokenWindow(int(t), int(ts) + offset, float(cf), int(d))
            for t, ts, cf, d in zip(ids[r, :c], times[r, :c], confs[r, :c], durs[r, :c])
        ])
    return out
