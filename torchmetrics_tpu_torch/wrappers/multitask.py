"""MultitaskWrapper (counterpart of ``torchmetrics_tpu/wrappers/multitask.py``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
    >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
    >>> from torchmetrics_tpu_torch.wrappers import MultitaskWrapper
    >>> metric = MultitaskWrapper({"cls": BinaryAccuracy(device="cpu"), "reg": MeanSquaredError(device="cpu")})
    >>> metric.update({"cls": torch.tensor([0.2, 0.8]), "reg": torch.tensor([1.0, 2.0])},
    ...               {"cls": torch.tensor([0, 1]), "reg": torch.tensor([1.0, 3.0])})
    >>> {k: round(float(v), 4) for k, v in sorted(metric.compute().items())}
    {'cls': 1.0, 'reg': 0.5}
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Optional, Union

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


class MultitaskWrapper(WrapperMetric):
    """A dict of task inputs routed to a dict of task metrics (or collections); results keyed
    ``<prefix><task><postfix>``."""

    is_differentiable = False

    def __init__(
        self,
        task_metrics: Dict[str, Union[Metric, MetricCollection]],
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(task_metrics, dict):
            raise TypeError(f"Expected argument `task_metrics` to be a dict. Found task_metrics = {task_metrics}")
        for metric in task_metrics.values():
            if not isinstance(metric, (Metric, MetricCollection)):
                raise TypeError(
                    "Expected each task's metric to be a Metric or a MetricCollection. "
                    f"Found a metric of type {type(metric)}"
                )
        super().__init__(task_metrics, **kwargs)
        self.task_metrics = task_metrics
        self._prefix = prefix or ""
        self._postfix = postfix or ""

    def _convert(self, d: Dict[str, Any]) -> Dict[str, Any]:
        return {f"{self._prefix}{k}{self._postfix}": v for k, v in d.items()}

    def update(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> None:
        if not self.task_metrics.keys() == task_preds.keys() == task_targets.keys():
            raise ValueError(
                "Expected arguments `task_preds` and `task_targets` to have the same keys as the wrapped `task_metrics`."
                f" Found task_preds.keys() = {task_preds.keys()}, task_targets.keys() = {task_targets.keys()}"
                f" and self.task_metrics.keys() = {self.task_metrics.keys()}"
            )
        for name, metric in self.task_metrics.items():
            metric.update(task_preds[name], task_targets[name])

    def compute(self) -> Dict[str, Any]:
        return self._convert({name: metric.compute() for name, metric in self.task_metrics.items()})

    def forward(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> Dict[str, Any]:
        return self._convert({
            name: metric(task_preds[name], task_targets[name]) for name, metric in self.task_metrics.items()
        })

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.forward(*args, **kwargs)

    def reset(self) -> None:
        for metric in self.task_metrics.values():
            metric.reset()

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MultitaskWrapper":
        mt = deepcopy(self)
        if prefix is not None:
            mt._prefix = prefix
        if postfix is not None:
            mt._postfix = postfix
        return mt

    def keys(self):
        return self.task_metrics.keys()

    def items(self):
        return self.task_metrics.items()

    def values(self):
        return self.task_metrics.values()
