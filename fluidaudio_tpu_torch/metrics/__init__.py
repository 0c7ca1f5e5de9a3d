from fluidaudio_tpu_torch.metrics.wer import wer, cer, levenshtein, WerBreakdown
from fluidaudio_tpu_torch.metrics.text_normalizer import normalize_for_scoring
from fluidaudio_tpu_torch.metrics.rttm import parse_rttm, write_rttm
from fluidaudio_tpu_torch.metrics.ami_corpus import (
    build_kaldi_split,
    load_ami_ground_truth,
    load_frame_aligned_der_reference,
    load_kaldi_der_reference,
    load_word_aligned_ground_truth,
)

__all__ = [
    "wer",
    "cer",
    "levenshtein",
    "WerBreakdown",
    "normalize_for_scoring",
    "parse_rttm",
    "write_rttm",
    "build_kaldi_split",
    "load_ami_ground_truth",
    "load_frame_aligned_der_reference",
    "load_kaldi_der_reference",
    "load_word_aligned_ground_truth",
]
