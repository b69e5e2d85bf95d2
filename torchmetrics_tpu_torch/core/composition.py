"""Lazy metric arithmetic (counterpart of ``torchmetrics_tpu/core/composition.py``).

The operator dunders of ``Metric`` build a ``CompositionalMetric``: its
``update``/``reset``/``persistent`` fan out to the operand metrics and its
``compute`` applies the operator to their results. It holds no state and
does no sync of its own: the operands sync themselves.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
    >>> top1_error = 1 - MulticlassAccuracy(num_classes=3, average="micro", device="cpu")
    >>> top1_error.update(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 2, 2]))
    >>> round(float(top1_error.compute()), 4)
    0.25
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from torchmetrics_tpu_torch.core.metric import Metric


class CompositionalMetric(Metric):
    """Composition of two metrics (or a metric and a constant) by an operator.

    ``metric_b`` is None for a unary operator. A constant operand becomes a
    tensor on the device of the metric operand.
    """

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, float, int, Any],
        metric_b: Optional[Union[Metric, float, int, Any]],
    ) -> None:
        device = next(m.device for m in (metric_a, metric_b) if isinstance(m, Metric))
        super().__init__(device=device)
        self.op = operator
        self.metric_a = self._operand(metric_a)
        self.metric_b = self._operand(metric_b)

    def _operand(self, x: Any) -> Any:
        if x is None or isinstance(x, Metric):
            return x
        return torch.as_tensor(x, device=self.device)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._computed = None
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    @property
    def update_called(self) -> bool:
        a = self.metric_a.update_called if isinstance(self.metric_a, Metric) else True
        b = self.metric_b.update_called if isinstance(self.metric_b, Metric) else True
        return a and b

    def compute(self) -> Any:
        if self.compute_with_cache and self._computed is not None:
            return self._computed
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        result = self.op(val_a) if val_b is None else self.op(val_a, val_b)
        if self.compute_with_cache:
            self._computed = result
        return result

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a = (
            self.metric_a(*args, **self.metric_a._filter_kwargs(**kwargs))
            if isinstance(self.metric_a, Metric)
            else self.metric_a
        )
        val_b = (
            self.metric_b(*args, **self.metric_b._filter_kwargs(**kwargs))
            if isinstance(self.metric_b, Metric)
            else self.metric_b
        )
        if val_a is None or (val_b is None and self.metric_b is not None):
            self._forward_cache = None
        elif val_b is None:
            self._forward_cache = self.op(val_a)
        else:
            self._forward_cache = self.op(val_a, val_b)
        self._computed = None
        return self._forward_cache

    def reset(self) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()
        self._computed = None
        self._forward_cache = None

    def persistent(self, mode: bool = False) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.persistent(mode)
        if isinstance(self.metric_b, Metric):
            self.metric_b.persistent(mode)

    def __repr__(self) -> str:
        op_name = getattr(self.op, "__name__", str(self.op))
        return f"{self.__class__.__name__}(\n  {op_name}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"
