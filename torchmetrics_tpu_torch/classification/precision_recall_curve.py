"""Precision-recall curves for the three tasks, exact and binned layouts.

Counterpart of ``torchmetrics_tpu/classification/precision_recall_curve.py``.
With ``thresholds=None`` (exact) the state is three ``cat`` lists of the
formatted batches: ``preds`` float32, ``target`` int32 and ``weight``
float32, ``(N,)`` each for the binary task, ``(N, C)``, ``(N,)``, ``(N,)``
for the multiclass one and ``(N, L)`` each for the multilabel one. With
``thresholds`` given (an int or a list) it is the binned int32 confusion
tensor, ``(T, 2, 2)``, ``(T, C, 2, 2)`` or ``(T, L, 2, 2)``, ``sum``-reduced,
which one call of a hand CUDA kernel updates on the card:
``binned_confmat_multiclass`` (``csrc/binned_confmat.cu``) for the
multiclass task, ``binned_confmat_multilabel`` (``csrc/binned_multilabel.cu``)
for the other two. With ``approx="sketch"`` the state is a fixed-grid
(negative, positive) histogram pair ``score_hist``, float32 ``(2, bins + 1)``,
``(C, 2, bins + 1)`` or ``(L, 2, bins + 1)``
(:class:`~torchmetrics_tpu_torch.sketches.QuantileSketch`, ``bins`` from
``approx_error``, 200 by default), which one launch of the ``quantile_hist``
kernel (``csrc/quantile_hist.cu``) adds each batch into, in place, on the card;
the curves are computed at the grid's edges, every point on the exact curve.
Explicit ``thresholds`` with ``approx="sketch"`` raise, as in the JAX package.

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

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _dispatch_task
from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _adjust_threshold_arg,
    _binary_precision_recall_curve_compute_binned,
    _binary_precision_recall_curve_compute_exact,
    _binary_prc_format,
    _binned_confmat_multiclass_accumulate,
    _binned_confmat_multilabel_accumulate,
    _binned_curve_accumulate,
    _binned_curves,
    _column_curve_lists,
    _multiclass_prc_format,
    _multilabel_prc_format,
    _sort_thresholds,
    _validate_thresholds,
)
from torchmetrics_tpu_torch.kernels.quantile_hist import _quantile_hist_plain, quantile_hist
from torchmetrics_tpu_torch.sketches.quantile import QuantileSketch
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

# the kwargs the curve task wrapper drops before it builds the task's class, as the JAX wrapper does
CURVE_DROPS = {
    "binary": ("num_classes", "num_labels", "average"),
    "multiclass": ("num_labels",),
    "multilabel": ("num_classes", "average"),
}


def _sketch_accumulate(hist: Tensor, p: Tensor, t: Tensor, w: Tensor, sketch: QuantileSketch) -> Tensor:
    """The curve histogram pair after one formatted batch.

    On the card it is one ``quantile_hist`` launch, which adds into ``hist``
    in place (the curve formats' weights are 0/1, the kernel's contract); a
    CPU state takes the plain version, out of place. The scores only choose a
    cell, so the histogram carries no gradient: scores that require grad are
    detached and take the same route.
    """
    p = p.detach()
    if hist.device.type == "cpu":
        return _quantile_hist_plain(hist, p, t, w, sketch)
    return quantile_hist(hist, p.contiguous(), t.contiguous(), w.contiguous(), sketch)


class _CurveBase(Metric):
    """Shared state handling for the curve metrics (exact, binned and sketch layouts).

    A subclass sets ``_format`` (the batch formatting of its task) and
    ``_accumulate_binned`` (its binned state update). In sketch mode the
    thresholds are the sketch's edges, so every binned ``_compute`` applies
    to the projected histogram unchanged.
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False
    _device_attrs = ("thresholds", "_thresholds_sorted", "_thresholds_order")

    #: QuantileSketch when ``approx="sketch"`` replaced the cat states
    _sketch: Optional[QuantileSketch] = None

    def _init_curve_state(self, thresholds: Union[int, Sequence[float], Tensor], confmat_shape: Tuple[int, ...]) -> None:
        self.thresholds = _adjust_threshold_arg(thresholds, self.device)
        if self.approx == "sketch":
            if self.thresholds is not None:
                raise ValueError(
                    "approx='sketch' replaces the unbounded thresholds=None state; explicit "
                    "`thresholds` are already a bounded binned state: drop one of the two"
                )
            self._sketch = QuantileSketch.for_error(self.approx_error)
            self.thresholds = self._sketch.edges_on(self.device)
            self._thresholds_sorted = self._thresholds_order = None
            # the kernel adds into the histogram in place (update_state's contract for these leaves)
            self._inplace_leaves = ("score_hist",)
            self.add_state("score_hist", self._sketch.init((*confmat_shape, 2)),
                           dist_reduce_fx=self._sketch.reduce_spec)
            return
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

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        p, t, w = self._format(self._tensor(preds), self._tensor(target))
        if self._sketch is not None:
            return {"score_hist": _sketch_accumulate(state["score_hist"], p, t, w, self._sketch)}
        if self.thresholds is None:
            return {"preds": state["preds"] + (p,), "target": state["target"] + (t,), "weight": state["weight"] + (w,)}
        sorted_thresholds = (self._thresholds_sorted, self._thresholds_order)
        return {"confmat": self._accumulate_binned(state["confmat"], p, t, w, sorted_thresholds)}

    def _exact_state(self, state: State) -> Tuple[Tensor, Tensor, Tensor]:
        return dim_zero_cat(state["preds"]), dim_zero_cat(state["target"]), dim_zero_cat(state["weight"])

    def compute_state(self, state: State) -> Any:
        if self._sketch is not None:  # the histogram pair as the binned confusion layout at the edges
            state = {**state, "confmat": self._sketch.curve_confmat(state["score_hist"])}
        return super().compute_state(state)


class BinaryPrecisionRecallCurve(_CurveBase):
    """Binary precision-recall curve.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryPrecisionRecallCurve
        >>> metric = BinaryPrecisionRecallCurve(device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.6, 0.35, 0.8]), torch.tensor([0, 1, 0, 1]))
        >>> precision, recall, thresholds = metric.compute()
        >>> precision
        tensor([0.5000, 0.6667, 1.0000, 1.0000, 1.0000])
    """

    def __init__(
        self,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _validate_thresholds(thresholds)
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_curve_state(thresholds, ())

    def _format(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        return _binary_prc_format(preds, target, self.ignore_index)

    def _accumulate_binned(self, confmat, p, t, w, sorted_thresholds) -> Tensor:
        return _binned_curve_accumulate(confmat, p, t, w, self.thresholds, sorted_thresholds)

    def _compute(self, state: State):
        if self.thresholds is None:
            return _binary_precision_recall_curve_compute_exact(*self._exact_state(state))
        return _binary_precision_recall_curve_compute_binned(state["confmat"], self.thresholds)


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

    def _format(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        return _multiclass_prc_format(preds, target, self.num_classes, self.ignore_index)

    def _accumulate_binned(self, confmat, p, t, w, sorted_thresholds) -> Tensor:
        return _binned_confmat_multiclass_accumulate(confmat, p, t, w, self.thresholds, self.num_classes,
                                                     sorted_thresholds)

    def _compute(self, state: State):
        if self.thresholds is None:  # per-class lists, as the JAX metric returns them
            return _column_curve_lists(*self._exact_state(state))
        return _binned_curves(state["confmat"], self.thresholds)


class MultilabelPrecisionRecallCurve(_CurveBase):
    def __init__(
        self,
        num_labels: int,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _validate_thresholds(thresholds)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_curve_state(thresholds, (num_labels,))

    def _format(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        return _multilabel_prc_format(preds, target, self.num_labels, self.ignore_index)

    def _accumulate_binned(self, confmat, p, t, w, sorted_thresholds) -> Tensor:
        return _binned_confmat_multilabel_accumulate(confmat, p, t, w, self.thresholds, sorted_thresholds)

    def _compute(self, state: State):
        if self.thresholds is None:  # per-label lists, as the JAX metric returns them
            return _column_curve_lists(*self._exact_state(state))
        return _binned_curves(state["confmat"], self.thresholds)


class PrecisionRecallCurve(_ClassificationTaskWrapper):
    """Task dispatch: ``PrecisionRecallCurve(task="binary" | "multiclass" | "multilabel", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        classes = {"binary": BinaryPrecisionRecallCurve, "multiclass": MulticlassPrecisionRecallCurve,
                   "multilabel": MultilabelPrecisionRecallCurve}
        return _dispatch_task(task, classes, CURVE_DROPS, args, kwargs)
