"""Multiclass average precision (counterpart of ``torchmetrics_tpu/classification/average_precision.py``).

Both state layouts of :class:`MulticlassPrecisionRecallCurve`: binned
(``thresholds`` an int or a list: the ``(T, C, 2, 2)`` int32 state that the
``binned_confmat_multiclass`` kernel updates on the card, as AUROC's) and
exact (``thresholds=None``: cat states, all classes sorted in one batched
sort at compute).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import MulticlassAveragePrecision
    >>> metric = MulticlassAveragePrecision(num_classes=3, device="cpu")
    >>> probs = torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1], [0.1, 0.2, 0.7], [0.3, 0.4, 0.3]])
    >>> metric.update(probs, torch.tensor([0, 1, 1, 2]))
    >>> round(float(metric.compute()), 4)
    0.7778
"""

from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _multiclass_only
from torchmetrics_tpu_torch.classification.precision_recall_curve import MulticlassPrecisionRecallCurve
from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.average_precision import (
    _average,
    _multiclass_binned_ap,
    _multiclass_exact_ap,
)


class MulticlassAveragePrecision(MulticlassPrecisionRecallCurve):
    """Area under the one-vs-rest precision-recall curves, averaged over classes."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, num_classes: int, average: Optional[str] = "macro", thresholds=None,
                 ignore_index=None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, average=None,
                         ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        self.average_ap = average

    def _compute(self, state: State):
        if self.thresholds is None:
            aps, support = _multiclass_exact_ap(*self._exact_state(state), self.num_classes)
        else:
            aps, support = _multiclass_binned_ap(state["confmat"], self.thresholds)
        if self.average_ap not in (None, "none", "macro", "weighted"):
            raise ValueError(f"Unknown average {self.average_ap}")
        return _average(aps, support, self.average_ap)


class AveragePrecision(_ClassificationTaskWrapper):
    """Task dispatch: ``AveragePrecision(task="multiclass", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        _multiclass_only(task, cls.__name__)
        kwargs.pop("num_labels", None)
        return MulticlassAveragePrecision(*args, **kwargs)
