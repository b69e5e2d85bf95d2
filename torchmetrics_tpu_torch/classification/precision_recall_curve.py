"""Multiclass precision-recall curve, exact and binned layouts.

Counterpart of ``torchmetrics_tpu/classification/precision_recall_curve.py``.
With ``thresholds=None`` (exact) the state is three ``cat`` lists of the
formatted batches: ``preds`` ``(N, C)`` float32, ``target`` ``(N,)`` int32
and ``weight`` ``(N,)`` float32. With ``thresholds`` given (an int or a
list) it is the binned ``(T, C, 2, 2)`` int32 confusion tensor,
``sum``-reduced. The sketch layout waits for a later slice.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import MulticlassPrecisionRecallCurve
    >>> metric = MulticlassPrecisionRecallCurve(num_classes=3, thresholds=5, device="cpu")
    >>> probs = torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1], [0.1, 0.2, 0.7], [0.3, 0.4, 0.3]])
    >>> metric.update(probs, torch.tensor([0, 1, 1, 2]))
    >>> precision, recall, thresholds = metric.compute()
    >>> precision[0]
    tensor([0.2500, 0.5000, 1.0000, 1.0000, 0.0000, 1.0000])
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _multiclass_only
from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _adjust_threshold_arg,
    _binned_confmat_multiclass_accumulate,
    _multiclass_exact_curves,
    _multiclass_prc_format,
    _sort_thresholds,
    _validate_thresholds,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class _CurveBase(Metric):
    """Shared state handling for the curve metrics (exact and binned layouts)."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False
    _device_attrs = ("thresholds", "_thresholds_sorted", "_thresholds_order")

    def _init_curve_state(self, thresholds: Union[int, Sequence[float], Tensor], confmat_shape: Tuple[int, ...]) -> None:
        self.thresholds = _adjust_threshold_arg(thresholds, self.device)
        if self.thresholds is None:
            self._thresholds_sorted = self._thresholds_order = None
            for name in ("preds", "target", "weight"):
                self.add_state(name, [], dist_reduce_fx="cat")
            return
        # sorted once here, so that an update on the card adds no launch for it
        self._thresholds_sorted, self._thresholds_order = _sort_thresholds(self.thresholds)
        # int32 cell counts: the weights are 0/1 ignore masks, so cells are integral
        self.add_state(
            "confmat",
            torch.zeros((self.thresholds.shape[0], *confmat_shape, 2, 2), dtype=torch.int32),
            dist_reduce_fx="sum",
        )


class MulticlassPrecisionRecallCurve(_CurveBase):
    def __init__(
        self,
        num_classes: int,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _validate_thresholds(thresholds)
        self.num_classes = num_classes
        self.average = average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_curve_state(thresholds, (num_classes,))

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        p, t, w = _multiclass_prc_format(self._tensor(preds), self._tensor(target), self.num_classes, self.ignore_index)
        if self.thresholds is None:
            return {"preds": state["preds"] + (p,), "target": state["target"] + (t,), "weight": state["weight"] + (w,)}
        confmat = _binned_confmat_multiclass_accumulate(
            state["confmat"], p, t, w, self.thresholds, self.num_classes,
            (self._thresholds_sorted, self._thresholds_order),
        )
        return {"confmat": confmat}

    def _exact_state(self, state: State) -> Tuple[Tensor, Tensor, Tensor]:
        return dim_zero_cat(state["preds"]), dim_zero_cat(state["target"]), dim_zero_cat(state["weight"])

    def _compute(self, state: State):
        if self.thresholds is None:  # per-class lists, as the JAX metric returns them
            curves = [c for _, c in _multiclass_exact_curves(*self._exact_state(state), self.num_classes)]
            return tuple([row for c in curves for row in c[i]] for i in range(3))
        confmat = state["confmat"]
        tp = confmat[:, :, 1, 1]
        fp = confmat[:, :, 0, 1]
        fn = confmat[:, :, 1, 0]
        ones = torch.ones((1, self.num_classes), device=confmat.device)
        precision = torch.cat([_safe_divide(tp, tp + fp), ones], dim=0).T
        recall = torch.cat([_safe_divide(tp, tp + fn), torch.zeros_like(ones)], dim=0).T
        return precision, recall, self.thresholds


class PrecisionRecallCurve(_ClassificationTaskWrapper):
    """Task dispatch: ``PrecisionRecallCurve(task="multiclass", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        _multiclass_only(task, cls.__name__)
        kwargs.pop("num_labels", None)
        return MulticlassPrecisionRecallCurve(*args, **kwargs)
