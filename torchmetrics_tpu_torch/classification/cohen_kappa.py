"""Cohen's kappa (counterpart of ``torchmetrics_tpu/classification/cohen_kappa.py``)."""

from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _dispatch_task
from torchmetrics_tpu_torch.classification.confusion_matrix import BinaryConfusionMatrix, MulticlassConfusionMatrix
from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_reduce


class BinaryCohenKappa(BinaryConfusionMatrix):
    """Cohen's kappa: agreement corrected for chance.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryCohenKappa
        >>> metric = BinaryCohenKappa(device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.8, 0.6, 0.3]), torch.tensor([0, 1, 0, 1]))
        >>> round(float(metric.compute()), 4)
        0.0
    """

    higher_is_better = True

    def __init__(self, threshold: float = 0.5, weights: Optional[str] = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(threshold=threshold, normalize=None, ignore_index=ignore_index,
                         validate_args=validate_args, **kwargs)
        self.weights = weights

    def _compute(self, state: State):
        return _cohen_kappa_reduce(state["confmat"], self.weights)


class MulticlassCohenKappa(MulticlassConfusionMatrix):
    higher_is_better = True

    def __init__(self, num_classes: int, weights: Optional[str] = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, normalize=None, ignore_index=ignore_index,
                         validate_args=validate_args, **kwargs)
        self.weights = weights

    def _compute(self, state: State):
        return _cohen_kappa_reduce(state["confmat"], self.weights)


class CohenKappa(_ClassificationTaskWrapper):
    """Task dispatch: ``CohenKappa(task="binary" | "multiclass", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        classes = {"binary": BinaryCohenKappa, "multiclass": MulticlassCohenKappa}
        return _dispatch_task(task, classes, {"binary": ("num_classes",), "multiclass": ("threshold",)}, args, kwargs)
