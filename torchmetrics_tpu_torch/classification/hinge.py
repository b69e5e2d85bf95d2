"""Hinge loss metric classes (counterpart of ``torchmetrics_tpu/classification/hinge.py``).

The state is ``measures`` (a float32 scalar, or ``(C,)`` in one-vs-all
mode) and ``total`` (float32), ``sum``-reduced: each batch adds its mean loss
times its count of non-ignored samples.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import BinaryHingeLoss
    >>> metric = BinaryHingeLoss(device="cpu")
    >>> metric.update(torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75]), torch.tensor([0, 0, 1, 1, 1]))
    >>> round(float(metric.compute()), 4)
    0.69
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.hinge import binary_hinge_loss, multiclass_hinge_loss


def _n_valid(target: Tensor, ignore_index: Optional[int]) -> Tensor:
    """The batch's count of samples whose target is not ``ignore_index``, as float32."""
    target = target.reshape(-1)
    if ignore_index is None:
        return torch.tensor(float(target.shape[0]), device=target.device)
    return (target != ignore_index).sum().to(torch.float32)


class _HingeBase(Metric):
    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def _init_hinge_state(self, size: int) -> None:
        self.add_state("measures", torch.zeros((size,) if size > 1 else ()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def _accumulate(self, state: State, loss: Tensor, target: Tensor) -> State:
        n_valid = _n_valid(target, self.ignore_index)
        return {"measures": state["measures"] + loss * n_valid, "total": state["total"] + n_valid}

    def _compute(self, state: State) -> Tensor:
        return state["measures"] / torch.clamp_min(state["total"], 1.0)


class BinaryHingeLoss(_HingeBase):
    def __init__(self, squared: bool = False, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.squared = squared
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_hinge_state(1)

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        preds, target = self._tensor(preds), self._tensor(target)
        loss = binary_hinge_loss(preds, target, self.squared, self.ignore_index, self.validate_args)
        return self._accumulate(state, loss, target)


class MulticlassHingeLoss(_HingeBase):
    """Multiclass hinge loss, Crammer-Singer (a scalar) or one-vs-all (one a class).

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassHingeLoss
        >>> metric = MulticlassHingeLoss(num_classes=3, multiclass_mode="one-vs-all", device="cpu")
        >>> metric.update(torch.tensor([[2.0, 0.5, 0.1], [0.2, 2.5, 0.3]]), torch.tensor([0, 1]))
        >>> [round(v, 4) for v in metric.compute().tolist()]
        [0.6771, 0.6684, 1.1002]
    """

    def __init__(self, num_classes: int, squared: bool = False, multiclass_mode: str = "crammer-singer",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.squared = squared
        self.multiclass_mode = multiclass_mode
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_hinge_state(num_classes if multiclass_mode == "one-vs-all" else 1)

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        preds, target = self._tensor(preds), self._tensor(target)
        loss = multiclass_hinge_loss(preds, target, self.num_classes, self.squared, self.multiclass_mode,
                                     self.ignore_index, self.validate_args)
        return self._accumulate(state, loss, target)


class HingeLoss(_ClassificationTaskWrapper):
    """Task dispatch: ``HingeLoss(task="binary" | "multiclass", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        task = str(task)
        if task == "binary":
            kwargs.pop("num_classes", None)
            kwargs.pop("multiclass_mode", None)
            return BinaryHingeLoss(*args, **kwargs)
        if task == "multiclass":
            return MulticlassHingeLoss(*args, **kwargs)
        raise ValueError(f"Task {task} not supported! (multilabel not supported for HingeLoss)")
