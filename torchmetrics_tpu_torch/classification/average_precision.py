"""Average precision for the three tasks (counterpart of ``torchmetrics_tpu/classification/average_precision.py``).

Both state layouts of the precision-recall curves: binned (``thresholds`` an
int or a list: the int32 confusion state that a ``binned_confmat`` kernel
updates on the card, as AUROC's) and exact (``thresholds=None``: cat states,
all columns sorted in one batched sort at compute).

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

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _dispatch_task
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.average_precision import (
    _ap_from_curve,
    _average,
    _binary_ap_compute,
    _column_aps,
    _multiclass_binned_ap,
    _multiclass_exact_ap,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_compute_binned,
)

AP_DROPS = {
    "binary": ("num_classes", "num_labels", "average"),
    "multiclass": ("num_labels",),
    "multilabel": ("num_classes",),
}


def _checked_average(aps, support, average):
    if average not in (None, "none", "macro", "weighted"):
        raise ValueError(f"Unknown average {average}")
    return _average(aps, support, average)


class BinaryAveragePrecision(BinaryPrecisionRecallCurve):
    """Area under the binary precision-recall curve (sklearn's step function)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def _compute(self, state: State):
        if self.thresholds is None:
            return _binary_ap_compute(*self._exact_state(state), None)
        precision, recall, _ = _binary_precision_recall_curve_compute_binned(state["confmat"], self.thresholds)
        return _ap_from_curve(precision, recall)


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
        return _checked_average(aps, support, self.average_ap)


class MultilabelAveragePrecision(MultilabelPrecisionRecallCurve):
    """Per-label average precision, averaged (``micro`` pools every label's elements into one curve)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, num_labels: int, average: Optional[str] = "macro", thresholds=None,
                 ignore_index=None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels=num_labels, thresholds=thresholds,
                         ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        self.average_ap = average

    def _compute(self, state: State):
        if self.thresholds is None:
            p, t, w = self._exact_state(state)
            if self.average_ap == "micro":
                return _binary_ap_compute(p.reshape(-1), t.reshape(-1), w.reshape(-1), None)
            aps, support = _column_aps(p, t, w), (t * w).sum(0).to(torch.float32)
        else:
            confmat = state["confmat"]
            if self.average_ap == "micro":
                precision, recall, _ = _binary_precision_recall_curve_compute_binned(
                    confmat.sum(1, dtype=torch.int32), self.thresholds)
                return _ap_from_curve(precision, recall)
            aps, support = _multiclass_binned_ap(confmat, self.thresholds)
        return _checked_average(aps, support, self.average_ap)


class AveragePrecision(_ClassificationTaskWrapper):
    """Task dispatch: ``AveragePrecision(task="binary" | "multiclass" | "multilabel", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        classes = {"binary": BinaryAveragePrecision, "multiclass": MulticlassAveragePrecision,
                   "multilabel": MultilabelAveragePrecision}
        return _dispatch_task(task, classes, AP_DROPS, args, kwargs)
