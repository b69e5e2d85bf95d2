"""Sum-and-count regression metrics (counterpart of ``torchmetrics_tpu/regression/errors.py``)."""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.regression.basic import _mean_squared_error_update


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
        sse, n = _mean_squared_error_update(self._tensor(preds), self._tensor(target), self.num_outputs)
        return {"measure": state["measure"] + sse, "total": state["total"] + n}

    def _compute(self, state: State) -> Tensor:
        mse = super()._compute(state)
        return mse if self.squared else torch.sqrt(mse)
