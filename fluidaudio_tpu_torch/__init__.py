"""FluidAudio in PyTorch: the port of `fluidaudio_tpu` to CUDA GPUs.

The JAX package `fluidaudio_tpu` stays the reference; this package mirrors
its layout (`utils/`, `asr/`, `ops/`, `models/`) so each module's
counterpart is easy to find. It imports `torch` and never `jax`.

Slices ported so far: Parakeet TDT batch ASR, bf16 or int8 encoder, with the
`language=` decode filter: `models.zoo.AsrModels.load(...)` ->
`asr.manager.AsrManager.transcribe`; FLAC input (`native/flac.py`); and
streaming ASR: `asr.streaming_eou.StreamingEouAsrManager` and
`asr.streaming_nemotron.StreamingNemotronAsrManager` over the cache-aware
encoder of `models/conformer_streaming.py`, with batched multi-stream
serving (`asr/multistream.py`); the Parakeet facades over those engines
(`asr/{sliding_window,unified,streaming_variants,arbitration,
multi_stream}.py`); and CTC keyword spotting with custom-vocabulary
boosting (`ops/ctc_decode.py`, `asr/keyword_spotter.py`,
`asr/custom_vocab/`). Entry points run on the GPU unless given
`device="cpu"`. Its hand-written GPU kernels are the Transformer-XL
rel-pos attention (`ops/attention.py`, `csrc/relpos_attention.cu`), the
dynamic-quantising int8 matmul (`ops/int8_matmul.py`,
`csrc/int8_matmul_fused.cu`) and the Sortformer head's f32 self-attention
(`ops/self_attention.py`, `csrc/self_attention.cu`), built with nvcc at
first use (`ops/build.py`).
"""

__version__ = "0.1.0"
