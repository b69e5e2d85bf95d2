"""ClasswiseWrapper (counterpart of ``torchmetrics_tpu/wrappers/classwise.py``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
    >>> from torchmetrics_tpu_torch.wrappers import ClasswiseWrapper
    >>> metric = ClasswiseWrapper(MulticlassAccuracy(num_classes=3, average=None, device="cpu"))
    >>> metric.update(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 2, 2]))
    >>> round(float(metric.compute()["multiclassaccuracy_2"]), 4)
    0.5
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


class ClasswiseWrapper(WrapperMetric):
    """A per-class vector result as a dict labelled ``<prefix><label or index><postfix>``."""

    def __init__(
        self,
        metric: Metric,
        labels: Optional[List[str]] = None,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `Metric` but got {metric}")
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Expected argument `labels` to either be `None` or a list of strings but got {labels}")
        super().__init__(metric, **kwargs)
        self.metric = metric
        self.labels = labels
        self._prefix = prefix
        self._postfix = postfix

    def _convert(self, x: Tensor) -> Dict[str, Tensor]:
        name = self.metric.__class__.__name__.lower()
        prefix = self._prefix if self._prefix is not None else (name + "_" if self._postfix is None else "")
        postfix = self._postfix or ""
        if self.labels is None:
            return {f"{prefix}{i}{postfix}": v for i, v in enumerate(x)}
        return {f"{prefix}{lab}{postfix}": v for lab, v in zip(self.labels, x)}

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.metric.update(*args, **kwargs)

    def compute(self) -> Dict[str, Tensor]:
        return self._convert(self.metric.compute())

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        return self._convert(self.metric(*args, **kwargs))

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        return self.forward(*args, **kwargs)

    def reset(self) -> None:
        self.metric.reset()

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        return self.metric._filter_kwargs(**kwargs)
