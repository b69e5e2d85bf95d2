"""Jaccard index, IoU (counterpart of ``torchmetrics_tpu/classification/jaccard.py``)."""

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
from torchmetrics_tpu_torch.functional.classification.jaccard import _jaccard_reduce


class BinaryJaccardIndex(BinaryConfusionMatrix):
    """Binary IoU: TP / (TP + FP + FN).

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryJaccardIndex
        >>> metric = BinaryJaccardIndex(device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.8, 0.6, 0.3]), torch.tensor([0, 1, 0, 1]))
        >>> round(float(metric.compute()), 4)
        0.3333
    """

    higher_is_better = True

    def __init__(self, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 validate_args: bool = True, zero_division: float = 0.0, **kwargs: Any) -> None:
        super().__init__(threshold=threshold, normalize=None, ignore_index=ignore_index,
                         validate_args=validate_args, **kwargs)
        self.zero_division = zero_division

    def _compute(self, state: State):
        return _jaccard_reduce(state["confmat"], "binary", zero_division=self.zero_division)


class MulticlassJaccardIndex(MulticlassConfusionMatrix):
    """Multiclass IoU; ``average="macro"`` over the classes present is the mIoU of segmentation."""

    higher_is_better = True

    def __init__(self, num_classes: int, average: Optional[str] = "macro", ignore_index: Optional[int] = None,
                 validate_args: bool = True, zero_division: float = 0.0, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, normalize=None, ignore_index=ignore_index,
                         validate_args=validate_args, **kwargs)
        self.average = average
        self.zero_division = zero_division

    def _compute(self, state: State):
        return _jaccard_reduce(state["confmat"], self.average, self.ignore_index, self.zero_division)


class MultilabelJaccardIndex(MultilabelConfusionMatrix):
    higher_is_better = True

    def __init__(self, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
                 ignore_index: Optional[int] = None, validate_args: bool = True,
                 zero_division: float = 0.0, **kwargs: Any) -> None:
        super().__init__(num_labels=num_labels, threshold=threshold, normalize=None,
                         ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        self.average = average
        self.zero_division = zero_division

    def _compute(self, state: State):
        return _jaccard_reduce(state["confmat"], self.average, zero_division=self.zero_division)


class JaccardIndex(_ClassificationTaskWrapper):
    """Task dispatch: ``JaccardIndex(task="binary" | "multiclass" | "multilabel", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        classes = {"binary": BinaryJaccardIndex, "multiclass": MulticlassJaccardIndex,
                   "multilabel": MultilabelJaccardIndex}
        drops = {**CONFMAT_DROPS, "binary": ("num_classes", "num_labels", "average")}
        return _dispatch_task(task, classes, drops, args, kwargs)
