"""R², explained variance and relative squared error (counterpart of ``torchmetrics_tpu/regression/variance.py``).

Sum-reduced float32 statistics per output and an int32 row count.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.regression.variance import (
    _MULTIOUTPUTS,
    _explained_variance_compute,
    _explained_variance_update,
    _r2_score_compute,
    _r2_score_update,
    _relative_squared_error_compute,
)

_R2_LEAVES = ("sum_squared_error", "sum_error", "sum_squared_target")


def _check_multioutput(multioutput: str) -> None:
    if multioutput not in _MULTIOUTPUTS:
        raise ValueError(f"Invalid input to argument `multioutput`. Choose one of the following: {_MULTIOUTPUTS}")


class _R2Statistics(Metric):
    """The three per-output sums of ``_r2_score_update`` and an int32 row count."""

    is_differentiable = True
    full_state_update = False

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        for name in _R2_LEAVES:
            self.add_state(name, torch.zeros(num_outputs), dist_reduce_fx="sum")
        # int32: sample counts are integers and a float32 count stops counting at 2**24
        self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum",
                       value_range=(0.0, float("inf")))

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        *sums, n = _r2_score_update(self._tensor(preds), self._tensor(target))
        out = {name: state[name] + s for name, s in zip(_R2_LEAVES, sums)}
        out["total"] = state["total"] + n.to(torch.int32)
        return out


class R2Score(_R2Statistics):
    """Coefficient of determination.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import R2Score
        >>> metric = R2Score(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(metric.compute()), 4)
        0.9486
    """

    higher_is_better = True

    def __init__(self, num_outputs: int = 1, adjusted: int = 0,
                 multioutput: str = "uniform_average", **kwargs: Any) -> None:
        super().__init__(num_outputs=num_outputs, **kwargs)
        if adjusted < 0 or not isinstance(adjusted, int):
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        self.adjusted = adjusted
        _check_multioutput(multioutput)
        self.multioutput = multioutput

    def _compute(self, state: State) -> Tensor:
        return _r2_score_compute(*(state[k] for k in _R2_LEAVES), state["total"], self.adjusted, self.multioutput)


class RelativeSquaredError(_R2Statistics):
    higher_is_better = False

    def __init__(self, num_outputs: int = 1, squared: bool = True, **kwargs: Any) -> None:
        super().__init__(num_outputs=num_outputs, **kwargs)
        self.squared = squared

    def _compute(self, state: State) -> Tensor:
        return _relative_squared_error_compute(*(state[k] for k in _R2_LEAVES), state["total"], self.squared)


class ExplainedVariance(Metric):
    """Explained variance ratio.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import ExplainedVariance
        >>> metric = ExplainedVariance(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(metric.compute()), 4)
        0.9572
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    _SUMS = ("sum_error", "sum_squared_error", "sum_target", "sum_squared_target")

    def __init__(self, multioutput: str = "uniform_average", num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_multioutput(multioutput)
        self.multioutput = multioutput
        self.add_state("num_obs", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum",
                       value_range=(0.0, float("inf")))
        for name in self._SUMS:
            self.add_state(name, torch.zeros(num_outputs), dist_reduce_fx="sum")

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        n, *sums = _explained_variance_update(self._tensor(preds), self._tensor(target))
        out = {name: state[name] + s for name, s in zip(self._SUMS, sums)}
        out["num_obs"] = state["num_obs"] + n.to(torch.int32)
        return out

    def _compute(self, state: State) -> Tensor:
        return _explained_variance_compute(state["num_obs"], *(state[k] for k in self._SUMS), self.multioutput)
