from fluidaudio_tpu_torch.metrics.wer import wer, cer, levenshtein, WerBreakdown

__all__ = [
    "wer",
    "cer",
    "levenshtein",
    "WerBreakdown",
    # not ported yet: normalize_for_scoring, parse_rttm, write_rttm and the
    # AMI corpus helpers (metrics/{text_normalizer,rttm,ami_corpus}.py)
]
