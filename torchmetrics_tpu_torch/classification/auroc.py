"""AUROC for the three tasks, exact and binned (counterpart of ``torchmetrics_tpu/classification/auroc.py``).

The states are those of the precision-recall curves. The multiclass and
multilabel computes take the areas of all columns at once: one ``(T, C)``
pass over the binned state, or one batched sort of the exact state (JAX
loops over the columns in Python; each column's area is the one it gives).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _dispatch_task
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.auroc import (
    _average_aurocs,
    _binary_auroc_compute,
    _binned_aurocs,
    _column_aurocs,
)
from torchmetrics_tpu_torch.functional.classification.roc import _binary_roc_compute_binned
from torchmetrics_tpu_torch.utilities.compute import _auc_compute
from torchmetrics_tpu_torch.utilities.data import one_hot

AUROC_DROPS = {
    "binary": ("num_classes", "num_labels", "average"),
    "multiclass": ("max_fpr", "num_labels"),
    "multilabel": ("max_fpr", "num_classes"),
}


def _binned_support(confmat: Tensor) -> Tensor:
    """int32 positives of every column of a ``(T, K, 2, 2)`` state: ``fn + tp`` at any threshold."""
    return confmat[0, :, 1, :].sum(-1, dtype=torch.int32)


class BinaryAUROC(BinaryPrecisionRecallCurve):
    """Area under the binary ROC curve, the partial area up to ``max_fpr`` if given.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryAUROC
        >>> metric = BinaryAUROC(device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.8, 0.6, 0.3]), torch.tensor([0, 1, 0, 1]))
        >>> round(float(metric.compute()), 4)
        0.75
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, max_fpr: Optional[float] = None, thresholds=None, ignore_index=None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        self.max_fpr = max_fpr

    def _compute(self, state: State):
        if self.thresholds is None:
            return _binary_auroc_compute(*self._exact_state(state), None, self.max_fpr)
        if self.max_fpr is not None:
            raise NotImplementedError("max_fpr with binned thresholds: use thresholds=None")
        fpr, tpr, _ = _binary_roc_compute_binned(state["confmat"], self.thresholds)
        return _auc_compute(fpr, tpr, direction=1.0)


class MulticlassAUROC(MulticlassPrecisionRecallCurve):
    """Macro-averaged one-vs-rest multiclass AUROC, exact or over binned thresholds.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAUROC
        >>> metric = MulticlassAUROC(num_classes=3, thresholds=5, device="cpu")
        >>> probs = torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1], [0.1, 0.2, 0.7], [0.3, 0.4, 0.3]])
        >>> metric.update(probs, torch.tensor([0, 1, 1, 2]))
        >>> round(float(metric.compute()), 4)
        0.7639
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, num_classes: int, average: Optional[str] = "macro", thresholds=None,
                 ignore_index=None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, average=None,
                         ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        self.average_auroc = average

    def _auc_per_class(self, state: State) -> Tuple[Tensor, Tensor]:
        """Per-class areas and supports in one pass over the class axis."""
        if self.thresholds is None:
            p, t, w = self._exact_state(state)
            return _column_aurocs(p, t, w), (one_hot(t, self.num_classes, torch.float32) * w[:, None]).sum(0)
        return _binned_aurocs(state["confmat"], self.thresholds), _binned_support(state["confmat"])

    def _compute(self, state: State):
        return _average_aurocs(*self._auc_per_class(state), self.average_auroc)


class MultilabelAUROC(MultilabelPrecisionRecallCurve):
    """Per-label AUROC, averaged (``micro`` pools every label's elements into one curve)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, num_labels: int, average: Optional[str] = "macro", thresholds=None,
                 ignore_index=None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels=num_labels, thresholds=thresholds,
                         ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        self.average_auroc = average

    def _compute(self, state: State):
        if self.thresholds is None:
            p, t, w = self._exact_state(state)
            if self.average_auroc == "micro":
                return _binary_auroc_compute(p.reshape(-1), t.reshape(-1), w.reshape(-1), None)
            aucs, support = _column_aurocs(p, t, w), (t * w).sum(0).to(torch.float32)
        else:
            confmat = state["confmat"]
            if self.average_auroc == "micro":
                fpr, tpr, _ = _binary_roc_compute_binned(confmat.sum(1, dtype=torch.int32), self.thresholds)
                return _auc_compute(fpr, tpr, direction=1.0)
            aucs, support = _binned_aurocs(confmat, self.thresholds), _binned_support(confmat)
        return _average_aurocs(aucs, support, self.average_auroc)


class AUROC(_ClassificationTaskWrapper):
    """Task dispatch: ``AUROC(task="binary" | "multiclass" | "multilabel", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        classes = {"binary": BinaryAUROC, "multiclass": MulticlassAUROC, "multilabel": MultilabelAUROC}
        return _dispatch_task(task, classes, AUROC_DROPS, args, kwargs)
