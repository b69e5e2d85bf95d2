"""chrF / chrF++ class (counterpart of ``torchmetrics_tpu/text/chrf.py``).

The state is six float32 count arrays (matching, prediction and reference
counts of each character and word n-gram order) on the metric's device, and
with ``return_sentence_level_score`` a cat list of the sentence scores.

Example::

    >>> from torchmetrics_tpu_torch.text import CHRFScore
    >>> metric = CHRFScore(device="cpu")
    >>> metric.update(["the cat is on the mat"], [["a cat is on the mat"]])
    >>> round(float(metric.compute()), 4)
    0.864
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.text.chrf import _ChrFStats, _chrf_score_update, _fscore
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

_STATS = ("matching_char", "matching_word", "preds_char", "preds_word", "target_char", "target_word")


class CHRFScore(Metric):
    """chrF/chrF++ over (prediction, references) pairs."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        n_char_order: int = 6,
        n_word_order: int = 2,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        return_sentence_level_score: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not isinstance(n_char_order, int) or n_char_order < 1:
            raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
        if not isinstance(n_word_order, int) or n_word_order < 0:
            raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
        if beta < 0:
            raise ValueError("Expected argument `beta` to be greater than 0.")
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score
        for name in _STATS:
            self.add_state(name, torch.zeros(n_char_order if name.endswith("char") else n_word_order),
                           dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_chrf", [], dist_reduce_fx="cat")

    def _update(
        self, state: State, preds: Union[str, Sequence[str]], target: Union[Sequence[str], Sequence[Sequence[str]]]
    ) -> State:
        stats = _ChrFStats(self.n_char_order, self.n_word_order)
        sentence_scores: Optional[List[float]] = [] if self.return_sentence_level_score else None
        _chrf_score_update(
            preds, target, stats, self.n_char_order, self.n_word_order,
            self.beta, self.lowercase, self.whitespace, sentence_scores,
        )
        new = {name: state[name] + torch.as_tensor(getattr(stats, name), dtype=torch.float32, device=self.device)
               for name in _STATS}
        if self.return_sentence_level_score:
            new["sentence_chrf"] = state["sentence_chrf"] + (
                torch.tensor(sentence_scores, dtype=torch.float32, device=self.device),)
        return new

    def _compute(self, state: State) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        host = [state[name].cpu().numpy() for name in _STATS]
        corpus = torch.tensor(_fscore(*host, float(self.n_char_order + self.n_word_order), self.beta),
                              dtype=torch.float32, device=self.device)
        if self.return_sentence_level_score:
            return corpus, dim_zero_cat(state["sentence_chrf"])
        return corpus
