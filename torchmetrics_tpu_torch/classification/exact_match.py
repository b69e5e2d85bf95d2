"""Exact match metric classes (counterpart of ``torchmetrics_tpu/classification/exact_match.py``).

Under ``multidim_average="global"`` the state is the float32 sums
``correct`` and ``total``; under ``"samplewise"`` it is the ``cat`` list
``correct`` of per-sample matches (the result is the per-sample vector
itself, so every sample is kept).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import MulticlassExactMatch
    >>> metric = MulticlassExactMatch(num_classes=3, device="cpu")
    >>> metric.update(torch.tensor([[0, 1], [2, 1]]), torch.tensor([[0, 1], [2, 2]]))
    >>> round(float(metric.compute()), 4)
    0.5
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.exact_match import (
    _multiclass_exact_match_stats,
    _multilabel_sample_match,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_validate_args,
    _multilabel_validate_args,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class _ExactMatchBase(Metric):
    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _init_em_state(self, multidim_average: str) -> None:
        self.multidim_average = multidim_average
        if multidim_average == "samplewise":
            self.add_state("correct", [], dist_reduce_fx="cat")
        else:
            self.add_state("correct", torch.zeros(()), dist_reduce_fx="sum")
            self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def _accumulate(self, state: State, samplewise: Tensor, valid_count: Optional[Tensor] = None) -> State:
        if self.multidim_average == "samplewise":
            return {"correct": tuple(state["correct"]) + (samplewise,)}
        if valid_count is None:
            valid_count = torch.tensor(float(samplewise.shape[0]), device=samplewise.device)
        return {"correct": state["correct"] + samplewise.sum(), "total": state["total"] + valid_count}

    def _compute(self, state: State) -> Tensor:
        if self.multidim_average == "samplewise":
            return dim_zero_cat(state["correct"])
        return _safe_divide(state["correct"], state["total"])


class MulticlassExactMatch(_ExactMatchBase):
    def __init__(self, num_classes: int, multidim_average: str = "global",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_em_state(multidim_average)

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        if self.validate_args:
            _multiclass_validate_args(self.num_classes, 1, None, self.multidim_average, self.ignore_index)
        samplewise, sample_valid = _multiclass_exact_match_stats(
            self._tensor(preds), self._tensor(target), self.num_classes, self.ignore_index
        )
        # the global total counts samples with a valid position: a fully ignored sample does not dilute the mean
        return self._accumulate(state, samplewise, sample_valid.sum())


class MultilabelExactMatch(_ExactMatchBase):
    def __init__(self, num_labels: int, threshold: float = 0.5, multidim_average: str = "global",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_labels = num_labels
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_em_state(multidim_average)

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        if self.validate_args:
            _multilabel_validate_args(self.num_labels, self.threshold, None, "samplewise", self.ignore_index)
        samplewise = _multilabel_sample_match(self._tensor(preds), self._tensor(target), self.threshold,
                                              self.ignore_index)
        return self._accumulate(state, samplewise)


class ExactMatch(_ClassificationTaskWrapper):
    """Task dispatch: ``ExactMatch(task="multiclass" | "multilabel", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        task = str(task)
        if task == "multiclass":
            kwargs.pop("threshold", None)
            kwargs.pop("num_labels", None)
            return MulticlassExactMatch(*args, **kwargs)
        if task == "multilabel":
            kwargs.pop("num_classes", None)
            return MultilabelExactMatch(*args, **kwargs)
        raise ValueError(f"Task {task} not supported! (binary not supported for ExactMatch)")
