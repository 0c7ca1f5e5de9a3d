"""Model zoo: assemble frontend + networks per ASR version, on one device.

Port of the Parakeet TDT part of `fluidaudio_tpu/models/zoo.py`. `load`
reads the JAX package's npz checkpoints (`encoder.npz`, `predictor.npz`,
`joint.npz`, `vocab.json`) from `checkpoint_dir`; with no checkpoint it
falls back to seeded random init (explicit opt-in), so benchmarks and
hermetic runs need no assets. The registry download cache is not ported:
pass `checkpoint_dir`.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import torch
from torch import nn

from fluidaudio_tpu_torch.asr.tokenizer import Tokenizer
from fluidaudio_tpu_torch.models.conformer import ConformerConfig, ConformerEncoder
from fluidaudio_tpu_torch.models.predictor import PredictorConfig, RnntJoint, RnntPredictor
from fluidaudio_tpu_torch.ops.mel import MelConfig, MelFrontend
from fluidaudio_tpu_torch.utils.logging import get_logger
from fluidaudio_tpu_torch.utils.weights import load_npz, load_state

logger = get_logger("models")


@dataclass(frozen=True)
class AsrVersionSpec:
    """Per-version model hyperparameters."""

    name: str
    conformer: ConformerConfig
    predictor: PredictorConfig
    mel: MelConfig


ASR_VERSIONS: dict[str, AsrVersionSpec] = {
    "v3": AsrVersionSpec(
        name="v3",
        conformer=ConformerConfig(d_model=1024, n_layers=24, n_heads=8),
        predictor=PredictorConfig(vocab_size=8192, n_layers=1, enc_hidden=1024),
        mel=MelConfig(normalize="per_feature"),
    ),
    "v2": AsrVersionSpec(
        name="v2",
        conformer=ConformerConfig(d_model=1024, n_layers=24, n_heads=8),
        predictor=PredictorConfig(vocab_size=1024, n_layers=2, enc_hidden=1024),
        mel=MelConfig(normalize="per_feature"),
    ),
    "tdt-ctc-110m": AsrVersionSpec(
        name="tdt-ctc-110m",
        conformer=ConformerConfig(d_model=512, n_layers=17, n_heads=8),
        predictor=PredictorConfig(vocab_size=1024, n_layers=1, enc_hidden=512,
                                  pred_hidden=640, joint_hidden=640),
        mel=MelConfig(normalize="per_feature"),
    ),
    "tdt-ja": AsrVersionSpec(
        name="tdt-ja",
        conformer=ConformerConfig(d_model=1024, n_layers=24, n_heads=8),
        predictor=PredictorConfig(vocab_size=3072, n_layers=1, enc_hidden=1024),
        mel=MelConfig(normalize="per_feature"),
    ),
    # tiny fixture for hermetic tests (trained npz in fluidaudio_tpu/assets)
    "test-tiny": AsrVersionSpec(
        name="test-tiny",
        conformer=ConformerConfig(d_model=64, n_layers=2, n_heads=4,
                                  subsampling_channels=32, dtype="float32"),
        predictor=PredictorConfig(vocab_size=64, n_layers=1, enc_hidden=64,
                                  pred_hidden=32, joint_hidden=32),
        mel=MelConfig(normalize="per_feature"),
    ),
}


def disable_tf32() -> None:
    """Keep f32 matmuls and convolutions in true f32 on the GPU (the mel DFT
    needs it on near-silence bins; cuDNN defaults to TF32 for convolutions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init in place: LeCun-normal weights (flax's Dense/Conv default),
    zero biases, unit norms, N(0, 0.02) embeddings."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "embedding":
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * 0.02)
        elif leaf == "weight" and p.ndim >= 2:
            fan_in = p[0].numel()
            std = fan_in ** -0.5
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * std)
        elif leaf in ("weight", "bn_scale"):
            p.fill_(1.0)
        else:  # biases, bn_bias, pos_bias_u/v
            p.zero_()


@dataclass
class AsrModels:
    spec: AsrVersionSpec
    mel: MelFrontend
    encoder: ConformerEncoder
    predictor: RnntPredictor
    joint: RnntJoint
    tokenizer: Tokenizer
    device: torch.device

    @property
    def blank_id(self) -> int:
        return self.spec.predictor.blank_id

    @classmethod
    def load(
        cls,
        version: str = "v3",
        checkpoint_dir: str | Path | None = None,
        *,
        device: torch.device | str = "cpu",
        allow_random_init: bool = True,
        rng_seed: int = 0,
    ) -> "AsrModels":
        spec = ASR_VERSIONS[version]
        device = torch.device(device)
        disable_tf32()

        mel = MelFrontend(spec.mel, device=device)
        encoder = ConformerEncoder(spec.conformer, device=device).eval()
        predictor = RnntPredictor(spec.predictor, device=device).eval()
        joint = RnntJoint(spec.predictor, device=device).eval()

        gen = torch.Generator(device=device).manual_seed(rng_seed)
        for part in (encoder, predictor, joint):
            random_init_(part, gen)

        loaded_any = False
        ckpt_dir = Path(checkpoint_dir) if checkpoint_dir else None
        if ckpt_dir is not None:
            for name, part in (("encoder", encoder), ("predictor", predictor),
                               ("joint", joint)):
                f = ckpt_dir / f"{name}.npz"
                if f.exists():
                    load_state(part, load_npz(f))
                    loaded_any = True
        if not loaded_any:
            if not allow_random_init:
                raise FileNotFoundError(
                    f"no checkpoints for {version} in {ckpt_dir}; pass allow_random_init=True"
                )
            logger.warning("ASR %s: no checkpoints in %s — using seeded random init",
                           version, ckpt_dir)

        vocab_file = ckpt_dir / "vocab.json" if ckpt_dir is not None else None
        if vocab_file is not None and vocab_file.exists():
            tokenizer = Tokenizer.from_json(vocab_file)
        else:
            tokenizer = Tokenizer(_placeholder_vocab(spec.predictor.vocab_size))
        return cls(spec, mel, encoder, predictor, joint, tokenizer, device)


def _placeholder_vocab(vocab_size: int) -> dict[int, str]:
    """Synthetic SentencePiece-shaped vocab so pipelines run without assets."""
    vocab = {}
    for i in range(vocab_size):
        piece = f"tok{i}"
        vocab[i] = ("▁" + piece) if i % 3 != 2 else piece
    return vocab
