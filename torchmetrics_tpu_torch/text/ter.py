"""Translation Edit Rate class (counterpart of ``torchmetrics_tpu/text/ter.py``).

The state is the float32 total of edits and of average reference lengths on
the metric's device, and with ``return_sentence_level_score`` a cat list of
the sentence scores.

Example::

    >>> from torchmetrics_tpu_torch.text import TranslationEditRate
    >>> metric = TranslationEditRate(device="cpu")
    >>> metric.update(["the cat is on the mat"], [["a cat is on the mat"]])
    >>> round(float(metric.compute()), 4)
    0.1667
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.text.ter import (
    _compute_ter_score_from_statistics,
    _corpus_statistics,
    _TercomTokenizer,
)
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class TranslationEditRate(Metric):
    """Corpus TER from the summed edits and reference lengths."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        for name, val in (
            ("normalize", normalize), ("no_punctuation", no_punctuation),
            ("lowercase", lowercase), ("asian_support", asian_support),
        ):
            if not isinstance(val, bool):
                raise ValueError(f"`{name}` must be a bool, got {val!r}.")
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support
        self._tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score
        self.add_state("total_num_edits", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total_tgt_length", torch.zeros(()), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_ter", [], dist_reduce_fx="cat")

    def _update(
        self, state: State, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]
    ) -> State:
        num_edits, tgt_length, per_sentence = _corpus_statistics(preds, target, self._tokenizer)
        new = {
            "total_num_edits": state["total_num_edits"] + num_edits,
            "total_tgt_length": state["total_tgt_length"] + tgt_length,
        }
        if self.return_sentence_level_score:
            new["sentence_ter"] = state["sentence_ter"] + (
                torch.tensor(per_sentence, dtype=torch.float32, device=self.device),)
        return new

    def _compute(self, state: State) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        score = torch.tensor(
            _compute_ter_score_from_statistics(float(state["total_num_edits"]), float(state["total_tgt_length"])),
            dtype=torch.float32, device=self.device,
        )
        if self.return_sentence_level_score:
            return score, dim_zero_cat(state["sentence_ter"])
        return score
