"""Text metrics of the port (counterpart of ``torchmetrics_tpu/text/__init__.py``)."""

from torchmetrics_tpu_torch.text.asr import (
    CharErrorRate,
    EditDistance,
    MatchErrorRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)
from torchmetrics_tpu_torch.text.bert import BERTScore
from torchmetrics_tpu_torch.text.bleu import BLEUScore, SacreBLEUScore
from torchmetrics_tpu_torch.text.chrf import CHRFScore
from torchmetrics_tpu_torch.text.distinct import DistinctNGrams
from torchmetrics_tpu_torch.text.eed import ExtendedEditDistance
from torchmetrics_tpu_torch.text.infolm import InfoLM
from torchmetrics_tpu_torch.text.perplexity import Perplexity
from torchmetrics_tpu_torch.text.rouge import ROUGEScore
from torchmetrics_tpu_torch.text.squad import SQuAD
from torchmetrics_tpu_torch.text.ter import TranslationEditRate

__all__ = [
    "BERTScore",
    "BLEUScore",
    "CharErrorRate",
    "CHRFScore",
    "DistinctNGrams",
    "EditDistance",
    "ExtendedEditDistance",
    "InfoLM",
    "MatchErrorRate",
    "Perplexity",
    "ROUGEScore",
    "SacreBLEUScore",
    "SQuAD",
    "TranslationEditRate",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
