"""Multilabel ranking metric classes (counterpart of ``torchmetrics_tpu/classification/ranking.py``).

The state is ``measure`` and ``total``, float32 scalars, ``sum``-reduced: a
batch of n samples adds its mean value times n, as in the JAX classes. An
update on the card is one ``ranking_pairs`` launch.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import MultilabelRankingAveragePrecision
    >>> metric = MultilabelRankingAveragePrecision(num_labels=3, device="cpu")
    >>> metric.update(torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.6, 0.1]]), torch.tensor([[1, 0, 1], [0, 0, 1]]))
    >>> round(float(metric.compute()), 4)
    0.6667
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.ranking import _ranking_per_sample


class _RankingBase(Metric):
    is_differentiable = False
    higher_is_better = None
    full_state_update = False
    _measure = ""

    def __init__(self, num_labels: int, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measure", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        preds, target = self._tensor(preds), self._tensor(target)
        n = preds.shape[0]
        value = _ranking_per_sample(preds, target, self._measure, self.ignore_index).mean()
        return {"measure": state["measure"] + value * n, "total": state["total"] + n}

    def _compute(self, state: State) -> Tensor:
        return state["measure"] / torch.clamp_min(state["total"], 1.0)


class MultilabelCoverageError(_RankingBase):
    higher_is_better = False
    _measure = "coverage"


class MultilabelRankingAveragePrecision(_RankingBase):
    higher_is_better = True
    _measure = "lrap"


class MultilabelRankingLoss(_RankingBase):
    higher_is_better = False
    _measure = "loss"
