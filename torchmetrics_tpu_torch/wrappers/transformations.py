"""Input-transforming wrappers (counterpart of ``torchmetrics_tpu/wrappers/transformations.py``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
    >>> from torchmetrics_tpu_torch.wrappers import BinaryTargetTransformer
    >>> metric = BinaryTargetTransformer(BinaryAccuracy(device="cpu"), threshold=0.5)
    >>> metric.update(torch.tensor([0.8, 0.2, 0.9, 0.4]), torch.tensor([0.9, 0.1, 0.3, 0.2]))
    >>> round(float(metric.compute()), 4)
    0.75
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


class MetricInputTransformer(WrapperMetric):
    """Base: ``transform_pred`` and ``transform_target`` applied before the wrapped metric's update."""

    def __init__(self, wrapped_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(wrapped_metric, Metric):
            raise TypeError(f"Expected wrapped metric to be an instance of `Metric` but received {wrapped_metric}")
        super().__init__(wrapped_metric, **kwargs)
        self.wrapped_metric = wrapped_metric

    def transform_pred(self, pred: Tensor) -> Tensor:
        return pred

    def transform_target(self, target: Tensor) -> Tensor:
        return target

    def update(self, pred: Tensor, target: Tensor, *args: Any, **kwargs: Any) -> None:
        self.wrapped_metric.update(self.transform_pred(pred), self.transform_target(target), *args, **kwargs)

    def compute(self) -> Any:
        return self.wrapped_metric.compute()

    def forward(self, pred: Tensor, target: Tensor, *args: Any, **kwargs: Any) -> Any:
        return self.wrapped_metric(self.transform_pred(pred), self.transform_target(target), *args, **kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def reset(self) -> None:
        self.wrapped_metric.reset()


class LambdaInputTransformer(MetricInputTransformer):
    """The caller's functions applied to the predictions and the targets."""

    def __init__(
        self,
        wrapped_metric: Metric,
        transform_pred: Callable = None,
        transform_target: Callable = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(wrapped_metric, **kwargs)
        if transform_pred is not None and not callable(transform_pred):
            raise TypeError(f"Expected `transform_pred` to be a callable but received {transform_pred}")
        if transform_target is not None and not callable(transform_target):
            raise TypeError(f"Expected `transform_target` to be a callable but received {transform_target}")
        self._transform_pred = transform_pred
        self._transform_target = transform_target

    def transform_pred(self, pred: Tensor) -> Tensor:
        return self._transform_pred(pred) if self._transform_pred is not None else pred

    def transform_target(self, target: Tensor) -> Tensor:
        return self._transform_target(target) if self._transform_target is not None else target


class BinaryTargetTransformer(MetricInputTransformer):
    """Continuous targets thresholded to int32 {0, 1} (``target > threshold``)."""

    def __init__(self, wrapped_metric: Metric, threshold: float = 0.0, **kwargs: Any) -> None:
        super().__init__(wrapped_metric, **kwargs)
        if not isinstance(threshold, (int, float)):
            raise TypeError(f"Expected `threshold` to be a float but received {threshold}")
        self.threshold = threshold

    def transform_target(self, target: Tensor) -> Tensor:
        return (torch.as_tensor(target) > self.threshold).to(torch.int32)
