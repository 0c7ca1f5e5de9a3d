"""FluidAudio in PyTorch: the port of `fluidaudio_tpu` to CUDA GPUs.

The JAX package `fluidaudio_tpu` stays the reference; this package mirrors
its layout (`utils/`, `asr/`, `ops/`, `models/`) so each module's
counterpart is easy to find. It imports `torch` and never `jax`.

Slice ported so far: Parakeet TDT batch ASR,
`models.zoo.AsrModels.load(...)` -> `asr.manager.AsrManager.transcribe`.
Its one hand-written GPU kernel is the Transformer-XL rel-pos attention
(`ops/attention.py`, source `csrc/relpos_attention.cu`), built with nvcc at
first use.
"""

__version__ = "0.1.0"
