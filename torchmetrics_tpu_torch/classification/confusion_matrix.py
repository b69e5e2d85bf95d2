"""Confusion matrices for the three tasks (counterpart of ``torchmetrics_tpu/classification/confusion_matrix.py``).

The state is one int32 ``confmat`` leaf with ``sum`` reduction: ``(2, 2)``,
``(C, C)`` or ``(L, 2, 2)``. The multiclass update adds into it in place, by
one launch of the ``confmat_multiclass`` CUDA kernel on the card (its plain
version on the CPU), so its ``update_state`` returns the tensor it was given:
copy a state first to keep it. ``compute``, ``forward``'s batch value and
``state_dict`` hand out copies of it. Cohen's kappa, MCC and the Jaccard index
subclass these classes, so under a ``MetricCollection``'s compute groups one
update serves them all.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _dispatch_task
from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_update,
    _multiclass_confmat_accumulate,
    _multilabel_confusion_matrix_update,
    _normalize_confmat,
)

# the kwargs ConfusionMatrix, MatthewsCorrCoef and JaccardIndex drop before they build a task's class
CONFMAT_DROPS = {
    "binary": ("num_classes", "num_labels"),
    "multiclass": ("threshold", "num_labels"),
    "multilabel": ("num_classes",),
}


class _ConfusionMatrixBase(Metric):
    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def _add_confmat(self, shape: tuple) -> None:
        # int32 cell counts: a float32 cell stops counting at 2**24
        self.add_state("confmat", torch.zeros(shape, dtype=torch.int32), dist_reduce_fx="sum",
                       value_range=(0.0, float("inf")))

    def _compute(self, state: State) -> Tensor:
        return _normalize_confmat(state["confmat"], self.normalize)


class BinaryConfusionMatrix(_ConfusionMatrixBase):
    """``(2, 2)`` confusion matrix of thresholded scores, rows the target.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryConfusionMatrix
        >>> metric = BinaryConfusionMatrix(device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.8, 0.6, 0.3]), torch.tensor([0, 1, 0, 1]))
        >>> metric.compute().tolist()
        [[1, 1], [1, 1]]
    """

    def __init__(self, threshold: float = 0.5, normalize: Optional[str] = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.threshold = threshold
        self.normalize = normalize
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._add_confmat((2, 2))

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        cm = _binary_confusion_matrix_update(self._tensor(preds), self._tensor(target), self.threshold,
                                             self.ignore_index)
        return {"confmat": state["confmat"] + cm}


class MulticlassConfusionMatrix(_ConfusionMatrixBase):
    """``(C, C)`` confusion matrix, rows the target class, columns the predicted one.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix
        >>> metric = MulticlassConfusionMatrix(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 2, 2]))
        >>> metric.compute().tolist()
        [[1, 0, 0], [0, 1, 0], [0, 1, 1]]
    """

    _inplace_leaves = ("confmat",)

    def __init__(self, num_classes: int, normalize: Optional[str] = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.normalize = normalize
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._add_confmat((num_classes, num_classes))

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        return {"confmat": _multiclass_confmat_accumulate(state["confmat"], preds, target, self.ignore_index)}


class MultilabelConfusionMatrix(_ConfusionMatrixBase):
    """``(L, 2, 2)`` confusion matrices, ``[[tn, fp], [fn, tp]]`` a label."""

    def __init__(self, num_labels: int, threshold: float = 0.5, normalize: Optional[str] = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_labels = num_labels
        self.threshold = threshold
        self.normalize = normalize
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._add_confmat((num_labels, 2, 2))

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        cm = _multilabel_confusion_matrix_update(self._tensor(preds), self._tensor(target), self.threshold,
                                                 self.ignore_index)
        return {"confmat": state["confmat"] + cm.to(torch.int32)}


class ConfusionMatrix(_ClassificationTaskWrapper):
    """Task dispatch: ``ConfusionMatrix(task="binary" | "multiclass" | "multilabel", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        classes = {"binary": BinaryConfusionMatrix, "multiclass": MulticlassConfusionMatrix,
                   "multilabel": MultilabelConfusionMatrix}
        return _dispatch_task(task, classes, CONFMAT_DROPS, args, kwargs)
