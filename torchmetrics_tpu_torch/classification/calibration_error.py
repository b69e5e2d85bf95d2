"""Calibration error metric classes (counterpart of ``torchmetrics_tpu/classification/calibration_error.py``).

The state is the binned sufficient statistics, ``sum``-reduced: ``conf_sum``
float32, ``acc_sum`` and ``count`` int32, each ``(n_bins + 1,)``. An update
on the card is one launch of the ``calibration_bins`` kernel
(``functional.classification.calibration_error._calibration_accumulate``).
With ``approx="sketch"`` the grid is sized by
``QuantileSketch.for_error(approx_error)`` (200 bins by default; the kernel
takes at most 1,023, so an ``approx_error`` below 1/1,023 raises on the card),
the three leaves are float32 and carry the sketch's sum
spec, as in the JAX package; the kernel still computes the update, and its
int32 counts of the batch are added into the float leaves.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import BinaryCalibrationError
    >>> metric = BinaryCalibrationError(n_bins=2, device="cpu")
    >>> metric.update(torch.tensor([0.2, 0.8, 0.6, 0.3]), torch.tensor([0, 1, 0, 1]))
    >>> round(float(metric.compute()), 4)
    0.225
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.calibration_error import (
    _calibration_accumulate,
    _ce_compute_from_bins,
    _ce_validate,
)
from torchmetrics_tpu_torch.sketches.quantile import QuantileSketch


class _CalibrationErrorBase(Metric):
    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    #: the class count of a row of scores; None for binary scores
    _rows_of: Optional[int] = None

    #: QuantileSketch when ``approx="sketch"`` sized the confidence grid
    _sketch: Optional[QuantileSketch] = None

    def _init_bins(self, n_bins: int, norm: str) -> None:
        if norm not in ("l1", "l2", "max"):
            raise ValueError(f"Argument `norm` is expected to be one of ('l1', 'l2', 'max') but got {norm}")
        _ce_validate(n_bins)
        self.norm = norm
        spec = "sum"
        if self.approx == "sketch":  # the binned state is a fixed-grid sketch: size the grid from the bound
            self._sketch = QuantileSketch.for_error(self.approx_error)
            n_bins = self._sketch.bins
            spec = self._sketch.reduce_spec
        self.n_bins = n_bins
        # n_bins + 1: the last bin holds conf == 1.0 exactly; the counts are int32, float32 in sketch mode
        counts = torch.zeros(n_bins + 1, dtype=torch.int32 if self._sketch is None else torch.float32)
        self.add_state("conf_sum", torch.zeros(n_bins + 1, dtype=torch.float32), dist_reduce_fx=spec)
        self.add_state("acc_sum", counts, dist_reduce_fx=spec, value_range=(0.0, float("inf")))
        self.add_state("count", counts, dist_reduce_fx=spec, value_range=(0.0, float("inf")))

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        old = (state["conf_sum"], state["acc_sum"], state["count"])
        if self._sketch is not None:  # the batch's int32 counts, then added into the float leaves
            zero = torch.zeros_like(old[1], dtype=torch.int32)
            old = (old[0], zero, zero)
        new = _calibration_accumulate(old, self._tensor(preds), self._tensor(target), self._rows_of,
                                      self.ignore_index)
        if self._sketch is not None:
            new = (new[0], state["acc_sum"] + new[1].to(torch.float32), state["count"] + new[2].to(torch.float32))
        return dict(zip(("conf_sum", "acc_sum", "count"), new))

    def _compute(self, state: State) -> Tensor:
        return _ce_compute_from_bins(state["conf_sum"], state["acc_sum"], state["count"], self.norm)


class BinaryCalibrationError(_CalibrationErrorBase):
    """Expected calibration error of binary scores: the confidence is the positive-class
    probability (sigmoid of the batch iff any score lies outside [0, 1]), the accuracy the target."""

    def __init__(self, n_bins: int = 15, norm: str = "l1", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_bins(n_bins, norm)


class MulticlassCalibrationError(_CalibrationErrorBase):
    """Expected calibration error of multiclass scores: the top-label confidence and whether
    the argmax is the target.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassCalibrationError
        >>> metric = MulticlassCalibrationError(num_classes=3, n_bins=3, device="cpu")
        >>> probs = torch.tensor([[0.8, 0.1, 0.1], [0.3, 0.5, 0.2], [0.2, 0.2, 0.6], [0.4, 0.4, 0.2]])
        >>> metric.update(probs, torch.tensor([0, 2, 2, 1]))
        >>> round(float(metric.compute()), 4)
        0.175
    """

    def __init__(self, num_classes: int, n_bins: int = 15, norm: str = "l1",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self._rows_of = num_classes
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._init_bins(n_bins, norm)


class CalibrationError(_ClassificationTaskWrapper):
    """Task dispatch: ``CalibrationError(task="binary" | "multiclass", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        task = str(task)
        if task == "binary":
            kwargs.pop("num_classes", None)
            return BinaryCalibrationError(*args, **kwargs)
        if task == "multiclass":
            return MulticlassCalibrationError(*args, **kwargs)
        raise ValueError(f"Task {task} not supported! (multilabel not supported for CalibrationError)")
