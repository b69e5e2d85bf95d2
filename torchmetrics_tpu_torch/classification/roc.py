"""ROC curves for the three tasks (counterpart of ``torchmetrics_tpu/classification/roc.py``).

The states and updates of the precision-recall curves, exact or binned; only
the compute differs.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import BinaryROC
    >>> metric = BinaryROC(device="cpu")
    >>> metric.update(torch.tensor([0.1, 0.6, 0.35, 0.8]), torch.tensor([0, 1, 0, 1]))
    >>> fpr, tpr, thresholds = metric.compute()
    >>> tpr
    tensor([0.0000, 0.5000, 1.0000, 1.0000, 1.0000])
"""

from __future__ import annotations

from typing import Any

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _dispatch_task
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _column_curve_lists
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute_binned,
    _binary_roc_compute_exact,
    _binned_rates,
)

ROC_DROPS = {"binary": ("num_classes", "num_labels"), "multiclass": ("num_labels",), "multilabel": ("num_classes",)}


class BinaryROC(BinaryPrecisionRecallCurve):
    def _compute(self, state: State):
        if self.thresholds is None:
            return _binary_roc_compute_exact(*self._exact_state(state))
        return _binary_roc_compute_binned(state["confmat"], self.thresholds)


class MulticlassROC(MulticlassPrecisionRecallCurve):
    def _compute(self, state: State):
        if self.thresholds is None:  # per-class lists, as the JAX metric returns them
            return _column_curve_lists(*self._exact_state(state), _binary_roc_compute_exact)
        return _binned_rates(state["confmat"], self.thresholds)


class MultilabelROC(MultilabelPrecisionRecallCurve):
    def _compute(self, state: State):
        if self.thresholds is None:  # per-label lists, as the JAX metric returns them
            return _column_curve_lists(*self._exact_state(state), _binary_roc_compute_exact)
        return _binned_rates(state["confmat"], self.thresholds)


class ROC(_ClassificationTaskWrapper):
    """Task dispatch: ``ROC(task="binary" | "multiclass" | "multilabel", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        classes = {"binary": BinaryROC, "multiclass": MulticlassROC, "multilabel": MultilabelROC}
        return _dispatch_task(task, classes, ROC_DROPS, args, kwargs)
