"""Aggregation metrics: sum, mean, max, min, cat and their running windows.

Counterpart of ``torchmetrics_tpu/aggregation.py``. The state of each is one
float32 leaf (two for the mean: the weighted sum and the weight), a list of
tensors for ``CatMetric``, and a ring buffer of the last ``window`` updates
for ``RunningMean`` and ``RunningSum``, indexed by the ``_n`` update counter
as in the JAX package.

``nan_strategy`` is the aggregators' own (the base ``Metric`` refuses the
kwarg for every other metric): ``"error"`` raises on a NaN input and
``"warn"`` warns, each reading one bool back to the host on every update
(as the JAX package and the reference do); ``"ignore"`` drops NaNs from the
reduction, a float replaces them, ``"disable"`` leaves them in.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.aggregation import MeanMetric
    >>> metric = MeanMetric(device="cpu")
    >>> metric.update(torch.tensor([1.0, 2.0, 3.0]))
    >>> round(float(metric.compute()), 4)
    2.0
"""

from __future__ import annotations

from typing import Any, Callable, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

_STRATEGIES = ("error", "warn", "ignore", "disable")


def _is_number(x: Any) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


class BaseAggregator(Metric):
    """Base of the aggregation metrics.

    Args:
        state_name: the state leaf the aggregator folds its inputs into.
        default_value: its initial value (an empty list for a cat state).
        dist_reduce_fx: how two copies of it combine.
        nan_strategy: ``"error"`` | ``"warn"`` | ``"ignore"`` | ``"disable"``
            | a float that replaces NaNs. ``"error"`` and ``"warn"`` read one
            bool back to the host on every update.
    """

    is_differentiable = None
    higher_is_better = None
    full_state_update = False
    __handles_nan_strategy__ = True

    #: the dtype of the aggregated values (the JAX package's default ``Metric.dtype``)
    dtype = torch.float32

    def __init__(
        self,
        state_name: str,
        default_value: Union[Tensor, list],
        dist_reduce_fx: str,
        nan_strategy: Union[str, float] = "error",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not _is_number(nan_strategy) and nan_strategy not in _STRATEGIES:
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {_STRATEGIES} but got {nan_strategy}."
            )
        self.nan_strategy = nan_strategy
        self.state_name = state_name
        self.add_state(state_name, default=default_value, dist_reduce_fx=dist_reduce_fx)

    def _handle_nan(self, x: Tensor) -> Tensor:
        """The NaN strategy on an input: impute a float; raise or warn (a host read)."""
        if self.nan_strategy in ("disable", "ignore"):
            return x  # "ignore" masks in the reduction, where the identity is known
        if _is_number(self.nan_strategy):
            return torch.where(torch.isnan(x), torch.tensor(self.nan_strategy, dtype=x.dtype, device=x.device), x)
        if bool(torch.isnan(x).any()):
            if self.nan_strategy == "error":
                raise RuntimeError("Encountered `nan` values in tensor")
            rank_zero_warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)
        return x

    def _cast_input(self, x: Union[float, Tensor]) -> Tensor:
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        return self._handle_nan(torch.atleast_1d(x))

    def _nan_mask_reduce(self, x: Tensor, reduce_fn: Callable, identity: float) -> Tensor:
        """``reduce_fn(x)`` with NaNs replaced by the reduction's identity (unless ``"disable"``)."""
        if self.nan_strategy == "disable":
            return reduce_fn(x)
        return reduce_fn(torch.where(torch.isnan(x), torch.tensor(identity, dtype=x.dtype, device=x.device), x))

    def _compute(self, state: State) -> Tensor:
        value = state[self.state_name]
        return dim_zero_cat(value) if isinstance(value, tuple) else value


class MaxMetric(BaseAggregator):
    """Running max.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.aggregation import MaxMetric
        >>> metric = MaxMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 5.0, 3.0]))
        >>> round(float(metric.compute()), 4)
        5.0
    """

    full_state_update = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max_value", torch.tensor(-float("inf")), "max", nan_strategy, **kwargs)

    def _update(self, state: State, value: Union[float, Tensor]) -> State:
        value = self._cast_input(value)
        return {"max_value": torch.maximum(state["max_value"], self._nan_mask_reduce(value, torch.max, -float("inf")))}


class MinMetric(BaseAggregator):
    """Running min."""

    full_state_update = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min_value", torch.tensor(float("inf")), "min", nan_strategy, **kwargs)

    def _update(self, state: State, value: Union[float, Tensor]) -> State:
        value = self._cast_input(value)
        return {"min_value": torch.minimum(state["min_value"], self._nan_mask_reduce(value, torch.min, float("inf")))}


class SumMetric(BaseAggregator):
    """Running sum.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.aggregation import SumMetric
        >>> metric = SumMetric(device="cpu")
        >>> metric.update(torch.tensor([1.0, 2.0, 3.0]))
        >>> round(float(metric.compute()), 4)
        6.0
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum_value", torch.zeros(()), "sum", nan_strategy, **kwargs)

    def _update(self, state: State, value: Union[float, Tensor]) -> State:
        value = self._cast_input(value)
        return {"sum_value": state["sum_value"] + self._nan_mask_reduce(value, torch.sum, 0.0)}


class CatMetric(BaseAggregator):
    """Every value seen, concatenated (``"ignore"`` drops NaNs, a host read on CUDA)."""

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("value", [], "cat", nan_strategy, **kwargs)

    def _update(self, state: State, value: Union[float, Tensor]) -> State:
        value = self._cast_input(value)
        if self.nan_strategy == "ignore":
            value = value[~torch.isnan(value)]
        return {"value": state["value"] + (value,)}


class MeanMetric(BaseAggregator):
    """Weighted running mean: ``sum(value * weight) / sum(weight)``.

    The weight sum stays float32, as in the JAX package: fractional weights
    are legal, and with unit weights the sum stops counting at 2**24 values.
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("mean_value", torch.zeros(()), "sum", nan_strategy, **kwargs)
        self.add_state("weight", default=torch.zeros(()), dist_reduce_fx="sum")

    def _weighted(self, value: Union[float, Tensor], weight: Union[float, Tensor]):
        """``(value, weight)`` of one update, float32, NaN values and their weights zeroed (unless ``"disable"``)."""
        value = self._cast_input(value)
        weight = torch.broadcast_to(torch.as_tensor(weight, dtype=self.dtype, device=self.device), value.shape)
        if self.nan_strategy != "disable":
            nan = torch.isnan(value)
            weight = torch.where(nan, 0.0, weight)
            value = torch.where(nan, 0.0, value)
        return value, weight

    def _update(self, state: State, value: Union[float, Tensor], weight: Union[float, Tensor] = 1.0) -> State:
        value, weight = self._weighted(value, weight)
        return {
            "mean_value": state["mean_value"] + (value * weight).sum(),
            "weight": state["weight"] + weight.sum(),
        }

    def _compute(self, state: State) -> Tensor:
        return state["mean_value"] / torch.clamp(state["weight"], min=torch.finfo(self.dtype).eps)


def _ring_set(ring: Tensor, slot: Tensor, value: Tensor) -> Tensor:
    """``ring`` with ``ring[slot] = value``, out of place, with no read back to the host."""
    return torch.where(torch.arange(ring.shape[0], device=ring.device) == slot, value, ring)


def _check_window(window: Any) -> None:
    if not (isinstance(window, int) and window > 0):
        raise ValueError(f"Argument `window` should be a positive integer but got {window}")


class RunningMean(MeanMetric):
    """Mean over the last ``window`` updates: a ring buffer of each update's
    weighted sum and weight, slot ``_n % window``."""

    def __init__(self, window: int = 5, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__(nan_strategy=nan_strategy, **kwargs)
        _check_window(window)
        self.window = window
        self.add_state("ring_value", default=torch.zeros(window), dist_reduce_fx=None)
        self.add_state("ring_weight", default=torch.zeros(window), dist_reduce_fx=None)

    def _update(self, state: State, value: Union[float, Tensor], weight: Union[float, Tensor] = 1.0) -> State:
        value, weight = self._weighted(value, weight)
        slot = torch.remainder(state["_n"], self.window)
        return {
            "mean_value": state["mean_value"],
            "weight": state["weight"],
            "ring_value": _ring_set(state["ring_value"], slot, (value * weight).sum()),
            "ring_weight": _ring_set(state["ring_weight"], slot, weight.sum()),
        }

    def _compute(self, state: State) -> Tensor:
        return state["ring_value"].sum() / torch.clamp(state["ring_weight"].sum(), min=torch.finfo(self.dtype).eps)


class RunningSum(SumMetric):
    """Sum over the last ``window`` updates: a ring buffer of each update's sum, slot ``_n % window``."""

    def __init__(self, window: int = 5, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__(nan_strategy=nan_strategy, **kwargs)
        _check_window(window)
        self.window = window
        self.add_state("ring_value", default=torch.zeros(window), dist_reduce_fx=None)

    def _update(self, state: State, value: Union[float, Tensor]) -> State:
        value = self._cast_input(value)
        slot = torch.remainder(state["_n"], self.window)
        return {
            "sum_value": state["sum_value"],
            "ring_value": _ring_set(state["ring_value"], slot, self._nan_mask_reduce(value, torch.sum, 0.0)),
        }

    def _compute(self, state: State) -> Tensor:
        return state["ring_value"].sum()
