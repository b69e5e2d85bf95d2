"""MinMaxMetric (counterpart of ``torchmetrics_tpu/wrappers/minmax.py``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
    >>> from torchmetrics_tpu_torch.wrappers import MinMaxMetric
    >>> metric = MinMaxMetric(BinaryAccuracy(device="cpu"))
    >>> metric.update(torch.tensor([0.2, 0.8]), torch.tensor([0, 1]))
    >>> round(float(metric.compute()["raw"]), 4)
    1.0
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


class MinMaxMetric(WrapperMetric):
    """The wrapped metric's value with the least and greatest it has computed, as float32 tensors on the metric's
    device."""

    full_state_update = True

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(f"Expected base metric to be an instance of `Metric` but received {base_metric}")
        super().__init__(base_metric, **kwargs)
        self._base_metric = base_metric
        self.min_val = float("inf")
        self.max_val = float("-inf")

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._base_metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(f"Returned value from base metric should be a float or scalar tensor, but got {val}.")
        v = float(val)
        self.min_val = v if v < self.min_val else self.min_val
        self.max_val = v if v > self.max_val else self.max_val
        return {"raw": val, "min": self._scalar(self.min_val), "max": self._scalar(self.max_val)}

    def _scalar(self, v: float) -> Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        self.update(*args, **kwargs)
        return self.compute()

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        return self.forward(*args, **kwargs)

    def reset(self) -> None:
        self._base_metric.reset()
        self.min_val = float("inf")
        self.max_val = float("-inf")

    @staticmethod
    def _is_suitable_val(val: Any) -> bool:
        """A Python number or a one-element tensor or array (a tensor's ``size`` is a method: ``numel`` counts)."""
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, Tensor):
            return val.numel() == 1
        if hasattr(val, "size"):
            return val.size == 1
        return False
