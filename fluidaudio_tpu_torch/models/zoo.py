"""Model zoo: assemble frontend + networks per ASR version, on one device.

Port of the Parakeet TDT part of `fluidaudio_tpu/models/zoo.py`. `load`
reads the JAX package's npz checkpoints (`encoder.npz`, `predictor.npz`,
`joint.npz`, `vocab.json`) from `checkpoint_dir`, or with
`checkpoint_dir=None` from the model cache as JAX does: the version's
registry folder (`DownloadUtils.repo_dir(spec.repo)`), validated and repaired
through `registry.doctor.ensure_repo` when `allow_random_init=False`. With no
checkpoint it falls back to seeded random init (explicit opt-in), so
benchmarks and hermetic runs need no assets.

`load` runs on the GPU unless given `device="cpu"`. `quantization="int8"`
builds the f32 encoder first (random init and/or npz), quantises its linear
weights once from those f32 values (`ops.quant.quantize_linear_state`, JAX
`quantize_dense_tree`) and loads them into the int8 encoder; only the
encoder is quantised, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from pathlib import Path

import torch
from torch import nn

from fluidaudio_tpu_torch.asr.tokenizer import Tokenizer
from fluidaudio_tpu_torch.models.conformer import ConformerConfig, ConformerEncoder
from fluidaudio_tpu_torch.models.predictor import PredictorConfig, RnntJoint, RnntPredictor
from fluidaudio_tpu_torch.ops.mel import MelConfig, MelFrontend
from fluidaudio_tpu_torch.ops.quant import quantize_linear_state
from fluidaudio_tpu_torch.registry import DownloadUtils, Repo
from fluidaudio_tpu_torch.registry.doctor import ensure_repo
from fluidaudio_tpu_torch.utils.device import resolve_device
from fluidaudio_tpu_torch.utils.logging import get_logger
from fluidaudio_tpu_torch.utils.weights import load_npz, load_state

logger = get_logger("models")


@dataclass(frozen=True)
class AsrVersionSpec:
    """Per-version model hyperparameters."""

    name: str
    repo: Repo
    conformer: ConformerConfig
    predictor: PredictorConfig
    mel: MelConfig


ASR_VERSIONS: dict[str, AsrVersionSpec] = {
    "v3": AsrVersionSpec(
        name="v3",
        repo=Repo.PARAKEET_V3,
        conformer=ConformerConfig(d_model=1024, n_layers=24, n_heads=8),
        predictor=PredictorConfig(vocab_size=8192, n_layers=1, enc_hidden=1024),
        mel=MelConfig(normalize="per_feature"),
    ),
    "v2": AsrVersionSpec(
        name="v2",
        repo=Repo.PARAKEET_V2,
        conformer=ConformerConfig(d_model=1024, n_layers=24, n_heads=8),
        predictor=PredictorConfig(vocab_size=1024, n_layers=2, enc_hidden=1024),
        mel=MelConfig(normalize="per_feature"),
    ),
    "tdt-ctc-110m": AsrVersionSpec(
        name="tdt-ctc-110m",
        repo=Repo.PARAKEET_TDT_CTC_110M,
        conformer=ConformerConfig(d_model=512, n_layers=17, n_heads=8),
        predictor=PredictorConfig(vocab_size=1024, n_layers=1, enc_hidden=512,
                                  pred_hidden=640, joint_hidden=640),
        mel=MelConfig(normalize="per_feature"),
    ),
    "tdt-ja": AsrVersionSpec(
        name="tdt-ja",
        repo=Repo.PARAKEET_JA,
        conformer=ConformerConfig(d_model=1024, n_layers=24, n_heads=8),
        predictor=PredictorConfig(vocab_size=3072, n_layers=1, enc_hidden=1024),
        mel=MelConfig(normalize="per_feature"),
    ),
    # tiny fixture for hermetic tests (trained npz in fluidaudio_tpu/assets)
    "test-tiny": AsrVersionSpec(
        name="test-tiny",
        repo=Repo.PARAKEET_V3,
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
    zero biases, unit norms, N(0, 0.02) embeddings and free tables (the
    Nemotron `prompt_embed`, the SenseVoice `embed`, the Cohere `pos_embed`)."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("embedding", "prompt_embed", "embed", "pos_embed"):
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
        device: torch.device | str | None = None,
        allow_random_init: bool = True,
        rng_seed: int = 0,
        dtype: str | None = None,
        quantization: str | None = None,
    ) -> "AsrModels":
        """`device=None` is the GPU (RuntimeError without one). `dtype` and
        `quantization` override the version's `ConformerConfig` fields."""
        spec = ASR_VERSIONS[version]
        overrides = {k: v for k, v in (("dtype", dtype), ("quantization", quantization))
                     if v is not None}
        if overrides:
            spec = replace(spec, conformer=replace(spec.conformer, **overrides))
        device = resolve_device(device)
        disable_tf32()

        int8 = spec.conformer.quantization == "int8"
        mel = MelFrontend(spec.mel, device=device)
        # int8: init/load the f32 encoder, quantise below
        enc_cfg = (replace(spec.conformer, dtype="float32", quantization="none") if int8
                   else spec.conformer)
        encoder = ConformerEncoder(enc_cfg, device=device).eval()
        predictor = RnntPredictor(spec.predictor, device=device).eval()
        joint = RnntJoint(spec.predictor, device=device).eval()

        gen = torch.Generator(device=device).manual_seed(rng_seed)
        for part in (encoder, predictor, joint):
            random_init_(part, gen)

        if checkpoint_dir:
            ckpt_dir = Path(checkpoint_dir)
        elif allow_random_init:
            ckpt_dir = DownloadUtils.repo_dir(spec.repo)
        else:
            # weights required: validate and repair the cache first (the
            # reference's loadWithAutoRecovery; OfflineError when offline)
            ckpt_dir = ensure_repo(spec.repo)
        loaded_any = False
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
        if int8:
            state = quantize_linear_state(encoder.state_dict())
            encoder = ConformerEncoder(spec.conformer, device=device).eval()
            load_state(encoder, state)

        vocab_file = ckpt_dir / "vocab.json"
        if vocab_file.exists():
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


def load_or_init(module: torch.nn.Module, ckpt: Path, rng_seed: int, device: torch.device,
                 label: str) -> bool:
    """Seeded random init on `device`, then the npz at `ckpt` if it exists
    (warning when it does not). -> whether the checkpoint was loaded."""
    random_init_(module, torch.Generator(device=device).manual_seed(rng_seed))
    if ckpt.exists():
        load_state(module, load_npz(ckpt))
        return True
    logger.warning("%s: no checkpoint at %s — seeded random init", label, ckpt)
    return False


def family_tokenizer(base: Path, vocab_size: int) -> Tokenizer:
    vocab_file = base / "vocab.json"
    return (Tokenizer.from_json(vocab_file) if vocab_file.exists()
            else Tokenizer(_placeholder_vocab(vocab_size)))
