"""Intrinsic (no-ground-truth) clustering metric classes (counterpart of
``torchmetrics_tpu/clustering/intrinsic.py``).

State: the accumulated data and labels, cat-reduced. Davies-Bouldin and Dunn
compute their centroid distances with one ``pairwise_lp`` launch on the card.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.clustering import CalinskiHarabaszScore
    >>> metric = CalinskiHarabaszScore(device="cpu")
    >>> x = torch.tensor([[0.0, 0.0], [0.0, 1.0], [5.0, 5.0], [5.0, 6.0]])
    >>> metric.update(x, torch.tensor([0, 0, 1, 1]))
    >>> round(float(metric.compute()), 4)
    100.0
"""

from __future__ import annotations

from typing import Any

from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.clustering.intrinsic import (
    calinski_harabasz_score,
    davies_bouldin_score,
    dunn_index,
)
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class _DataLabelMetric(Metric):
    is_differentiable = False
    full_state_update = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("data", [], dist_reduce_fx="cat")
        self.add_state("labels", [], dist_reduce_fx="cat")

    def _update(self, state: State, data: Tensor, labels: Tensor) -> State:
        return {
            "data": tuple(state["data"]) + (self._tensor(data),),
            "labels": tuple(state["labels"]) + (self._tensor(labels),),
        }

    def _gathered(self, state: State):
        return dim_zero_cat(state["data"]), dim_zero_cat(state["labels"])


class CalinskiHarabaszScore(_DataLabelMetric):
    """Variance-ratio criterion."""

    higher_is_better = True
    plot_lower_bound = 0.0

    def _compute(self, state: State) -> Tensor:
        return calinski_harabasz_score(*self._gathered(state))


class DaviesBouldinScore(_DataLabelMetric):
    """Average worst-case cluster similarity.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import DaviesBouldinScore
        >>> metric = DaviesBouldinScore(device="cpu")
        >>> x = torch.tensor([[0.0, 0.0], [0.0, 1.0], [5.0, 5.0], [5.0, 6.0]])
        >>> metric.update(x, torch.tensor([0, 0, 1, 1]))
        >>> round(float(metric.compute()), 4)
        0.1414
    """

    higher_is_better = False
    plot_lower_bound = 0.0

    def _compute(self, state: State) -> Tensor:
        return davies_bouldin_score(*self._gathered(state))


class DunnIndex(_DataLabelMetric):
    """Separation/compactness ratio."""

    higher_is_better = True
    plot_lower_bound = 0.0

    def __init__(self, p: float = 2, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.p = p

    def _compute(self, state: State) -> Tensor:
        data, labels = self._gathered(state)
        return dunn_index(data, labels, self.p)
