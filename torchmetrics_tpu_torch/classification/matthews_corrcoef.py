"""Matthews correlation coefficient (counterpart of ``torchmetrics_tpu/classification/matthews_corrcoef.py``)."""

from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _dispatch_task
from torchmetrics_tpu_torch.classification.confusion_matrix import (
    CONFMAT_DROPS,
    BinaryConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce


class BinaryMatthewsCorrCoef(BinaryConfusionMatrix):
    higher_is_better = True

    def __init__(self, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(threshold=threshold, normalize=None, ignore_index=ignore_index,
                         validate_args=validate_args, **kwargs)

    def _compute(self, state: State):
        return _matthews_corrcoef_reduce(state["confmat"])


class MulticlassMatthewsCorrCoef(MulticlassConfusionMatrix):
    """Matthews correlation from the confusion matrix.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassMatthewsCorrCoef
        >>> metric = MulticlassMatthewsCorrCoef(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 2, 2]))
        >>> round(float(metric.compute()), 4)
        0.7
    """

    higher_is_better = True

    def __init__(self, num_classes: int, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, normalize=None, ignore_index=ignore_index,
                         validate_args=validate_args, **kwargs)

    def _compute(self, state: State):
        return _matthews_corrcoef_reduce(state["confmat"])


class MultilabelMatthewsCorrCoef(MultilabelConfusionMatrix):
    higher_is_better = True

    def __init__(self, num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels=num_labels, threshold=threshold, normalize=None,
                         ignore_index=ignore_index, validate_args=validate_args, **kwargs)

    def _compute(self, state: State):
        return _matthews_corrcoef_reduce(state["confmat"])


class MatthewsCorrCoef(_ClassificationTaskWrapper):
    """Task dispatch: ``MatthewsCorrCoef(task="binary" | "multiclass" | "multilabel", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        classes = {"binary": BinaryMatthewsCorrCoef, "multiclass": MulticlassMatthewsCorrCoef,
                   "multilabel": MultilabelMatthewsCorrCoef}
        return _dispatch_task(task, classes, CONFMAT_DROPS, args, kwargs)
