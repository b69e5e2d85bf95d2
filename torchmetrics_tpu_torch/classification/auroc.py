"""Multiclass AUROC, binned layout (counterpart of ``torchmetrics_tpu/classification/auroc.py``)."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _multiclass_only
from torchmetrics_tpu_torch.classification.precision_recall_curve import MulticlassPrecisionRecallCurve
from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.roc import _binary_roc_compute_binned
from torchmetrics_tpu_torch.utilities.compute import _auc_compute, _safe_divide


class MulticlassAUROC(MulticlassPrecisionRecallCurve):
    """Macro-averaged one-vs-rest multiclass AUROC over binned thresholds.

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
        if thresholds is None:
            raise NotImplementedError(
                "MulticlassAUROC(thresholds=None), the exact AUROC, is not ported yet: pass an int or a list "
                "of thresholds"
            )
        super().__init__(num_classes=num_classes, thresholds=thresholds, average=None,
                         ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        self.average_auroc = average

    def _auc_per_class(self, state: State) -> Tuple[Tensor, Tensor]:
        """Per-class areas and supports in one pass over the class axis.

        The JAX version loops over the classes in Python; here the curves of
        all C classes are the columns of one ``(T, C)`` tensor.
        """
        confmat = state["confmat"]  # (T, C, 2, 2)
        fpr, tpr, _ = _binary_roc_compute_binned(confmat, self.thresholds)  # (T, C) each
        aucs = _auc_compute(fpr, tpr, direction=1.0, dim=0)
        support = confmat[0, :, 1, :].sum(-1, dtype=torch.int32)
        return aucs, support

    def _compute(self, state: State):
        aucs, support = self._auc_per_class(state)
        if self.average_auroc in (None, "none"):
            return aucs
        if self.average_auroc == "macro":
            return aucs.mean()
        if self.average_auroc == "weighted":
            return (aucs * _safe_divide(support, support.sum(dtype=torch.int32))).sum()
        raise ValueError(f"Unknown average {self.average_auroc}")


class AUROC(_ClassificationTaskWrapper):
    """Task dispatch: ``AUROC(task="multiclass", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        _multiclass_only(task, cls.__name__)
        kwargs.pop("max_fpr", None)
        kwargs.pop("num_labels", None)
        return MulticlassAUROC(*args, **kwargs)
