from fluidaudio_tpu_torch.asr.custom_vocab.context import CustomVocabularyContext, VocabularyTerm
from fluidaudio_tpu_torch.asr.custom_vocab.bktree import BKTree
from fluidaudio_tpu_torch.asr.custom_vocab.ctc_spotter import ctc_keyword_dp, spot_keywords, KeywordSpot
from fluidaudio_tpu_torch.asr.custom_vocab.rescorer import VocabularyRescorer

__all__ = [
    "CustomVocabularyContext",
    "VocabularyTerm",
    "BKTree",
    "ctc_keyword_dp",
    "spot_keywords",
    "KeywordSpot",
    "VocabularyRescorer",
]
