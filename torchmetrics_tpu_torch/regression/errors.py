"""Elementwise-error regression metrics (counterpart of ``torchmetrics_tpu/regression/errors.py``).

Most keep a (sum of errors, int32 count) pair, ``sum``-reduced; a float32
count would stop counting at 2**24 rows.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.regression.basic import (
    _EPS,
    _check_minkowski_p,
    _check_tweedie_power,
    _critical_success_index_update,
    _log_cosh_error_update,
    _mean_absolute_error_update,
    _mean_absolute_percentage_error_update,
    _mean_squared_error_update,
    _mean_squared_log_error_update,
    _minkowski_distance_update,
    _symmetric_mape_update,
    _tweedie_deviance_update,
    _weighted_mape_update,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class _SumCountMetric(Metric):
    """Base for (sum of errors, count) metrics."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    #: dtype of the ``total`` counter: element counts are integers, and a
    #: float32 count stops incrementing at 2**24
    _count_dtype = torch.int32

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        default = torch.zeros(num_outputs) if num_outputs > 1 else torch.zeros(())
        self.add_state("measure", default, dist_reduce_fx="sum", value_range=(0.0, float("inf")))
        self.add_state(
            "total", torch.zeros((), dtype=self._count_dtype), dist_reduce_fx="sum", value_range=(0.0, float("inf"))
        )

    def _compute(self, state: State) -> Tensor:
        return state["measure"] / torch.clamp(state["total"].to(state["measure"].dtype), min=1.0)

    def _add(self, state: State, measure: Tensor, n) -> State:
        return {"measure": state["measure"] + measure, "total": state["total"] + n}


class MeanSquaredError(_SumCountMetric):
    """Mean squared error.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
        >>> metric = MeanSquaredError(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(metric.compute()), 4)
        0.375
    """

    def __init__(self, squared: bool = True, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(num_outputs=num_outputs, **kwargs)
        if not isinstance(squared, bool):
            raise ValueError(f"Expected argument `squared` to be a boolean but got {squared}")
        self.squared = squared

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        return self._add(state, *_mean_squared_error_update(self._tensor(preds), self._tensor(target),
                                                            self.num_outputs))

    def _compute(self, state: State) -> Tensor:
        mse = super()._compute(state)
        return mse if self.squared else torch.sqrt(mse)


class MeanAbsoluteError(_SumCountMetric):
    """Mean absolute error.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MeanAbsoluteError
        >>> metric = MeanAbsoluteError(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(metric.compute()), 4)
        0.5
    """

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        return self._add(state, *_mean_absolute_error_update(self._tensor(preds), self._tensor(target),
                                                             self.num_outputs))


class MeanAbsolutePercentageError(_SumCountMetric):
    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        return self._add(state, *_mean_absolute_percentage_error_update(self._tensor(preds), self._tensor(target)))


class SymmetricMeanAbsolutePercentageError(_SumCountMetric):
    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        return self._add(state, *_symmetric_mape_update(self._tensor(preds), self._tensor(target)))


class WeightedMeanAbsolutePercentageError(_SumCountMetric):
    _count_dtype = torch.float32  # total is a sum of |target|, not an element count

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        return self._add(state, *_weighted_mape_update(self._tensor(preds), self._tensor(target)))

    def _compute(self, state: State) -> Tensor:
        return state["measure"] / torch.clamp(state["total"], min=_EPS)


class MeanSquaredLogError(_SumCountMetric):
    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        return self._add(state, *_mean_squared_log_error_update(self._tensor(preds), self._tensor(target)))


class LogCoshError(_SumCountMetric):
    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        return self._add(state, *_log_cosh_error_update(self._tensor(preds), self._tensor(target), self.num_outputs))


class MinkowskiDistance(Metric):
    """``(sum |preds - target|^p)^(1/p)``.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MinkowskiDistance
        >>> metric = MinkowskiDistance(p=3.0, device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(metric.compute()), 4)
        1.0772
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, p: float, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_minkowski_p(p)
        self.p = p
        self.add_state("minkowski_dist_sum", torch.zeros(()), dist_reduce_fx="sum")

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        dist = _minkowski_distance_update(self._tensor(preds), self._tensor(target), self.p)
        return {"minkowski_dist_sum": state["minkowski_dist_sum"] + dist}

    def _compute(self, state: State) -> Tensor:
        return state["minkowski_dist_sum"] ** (1.0 / self.p)


class TweedieDevianceScore(_SumCountMetric):
    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_tweedie_power(power)
        self.power = power

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        return self._add(state, *_tweedie_deviance_update(self._tensor(preds), self._tensor(target), self.power))


class CriticalSuccessIndex(Metric):
    """``hits / (hits + misses + false alarms)`` of values at or above ``threshold``;
    per step of ``keep_sequence_dim`` (cat states) if given."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    _LEAVES = ("hits", "misses", "false_alarms")

    def __init__(self, threshold: float, keep_sequence_dim: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.threshold = threshold
        self.keep_sequence_dim = keep_sequence_dim
        for name in self._LEAVES:
            if keep_sequence_dim is None:
                self.add_state(name, torch.zeros(()), dist_reduce_fx="sum")
            else:
                self.add_state(name, [], dist_reduce_fx="cat")

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        counts = _critical_success_index_update(self._tensor(preds), self._tensor(target), self.threshold,
                                                self.keep_sequence_dim)
        if self.keep_sequence_dim is None:
            return {name: state[name] + c for name, c in zip(self._LEAVES, counts)}
        return {name: state[name] + (c,) for name, c in zip(self._LEAVES, counts)}

    def _compute(self, state: State) -> Tensor:
        hits, misses, fa = (dim_zero_cat(state[name]) for name in self._LEAVES)
        return _safe_divide(hits, hits + misses + fa)
