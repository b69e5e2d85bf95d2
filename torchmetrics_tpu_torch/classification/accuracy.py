"""Accuracy for the three tasks (counterpart of ``torchmetrics_tpu/classification/accuracy.py``)."""

from __future__ import annotations

from typing import Any

from torchmetrics_tpu_torch.classification.base import STAT_DROPS, _ClassificationTaskWrapper, _dispatch_task
from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
)
from torchmetrics_tpu_torch.core.metric import Metric, State


class BinaryAccuracy(BinaryStatScores):
    """Binary accuracy: the share of thresholded predictions that match the targets.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> metric = BinaryAccuracy(device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.8, 0.6, 0.3]), torch.tensor([0, 1, 0, 1]))
        >>> round(float(metric.compute()), 4)
        0.5
    """

    _stat_kind = "accuracy"
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def _compute(self, state: State):
        return self._reduce_kind(state, "binary")


class MulticlassAccuracy(MulticlassStatScores):
    """Multiclass accuracy over int labels or (N, C) probabilities.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> metric = MulticlassAccuracy(num_classes=3, average='micro', device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 2, 2]))
        >>> round(float(metric.compute()), 4)
        0.75
    """

    _stat_kind = "accuracy"
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def _compute(self, state: State):
        return self._reduce_kind(state, self.average)


class MultilabelAccuracy(MultilabelStatScores):
    """Multilabel accuracy: tp and tn count as correct, per label."""

    _stat_kind = "accuracy"
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def _compute(self, state: State):
        return self._reduce_kind(state, self.average)


class Accuracy(_ClassificationTaskWrapper):
    """Task dispatch: ``Accuracy(task="binary" | "multiclass" | "multilabel", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        classes = {"binary": BinaryAccuracy, "multiclass": MulticlassAccuracy, "multilabel": MultilabelAccuracy}
        return _dispatch_task(task, classes, STAT_DROPS, args, kwargs)
