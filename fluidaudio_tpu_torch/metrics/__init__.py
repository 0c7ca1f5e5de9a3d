from fluidaudio_tpu_torch.metrics.wer import wer, cer, levenshtein, WerBreakdown
from fluidaudio_tpu_torch.metrics.text_normalizer import normalize_for_scoring

__all__ = [
    "wer",
    "cer",
    "levenshtein",
    "WerBreakdown",
    "normalize_for_scoring",
    # not ported yet: parse_rttm, write_rttm and the AMI corpus helpers
    # (metrics/{rttm,ami_corpus}.py)
]
