"""Multiclass accuracy (counterpart of ``torchmetrics_tpu/classification/accuracy.py``)."""

from __future__ import annotations

from typing import Any

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _multiclass_only
from torchmetrics_tpu_torch.classification.stat_scores import MulticlassStatScores
from torchmetrics_tpu_torch.core.metric import Metric, State


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


class Accuracy(_ClassificationTaskWrapper):
    """Task dispatch: ``Accuracy(task="multiclass", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        _multiclass_only(task, cls.__name__)
        kwargs.pop("threshold", None)
        kwargs.pop("num_labels", None)
        return MulticlassAccuracy(*args, **kwargs)
