"""Extrinsic (label-comparison) clustering metric classes (counterpart of
``torchmetrics_tpu/clustering/extrinsic.py``).

Cluster ids are arbitrary per run, so the state is the label streams
(cat-reduced list states) and the contingency matrix is counted once at
compute: one ``confmat_multiclass`` launch on the card (two for
``VMeasureScore``, which takes homogeneity and completeness).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.clustering import AdjustedRandScore
    >>> metric = AdjustedRandScore(device="cpu")
    >>> metric.update(torch.tensor([0, 0, 1, 1, 2, 2]), torch.tensor([0, 0, 1, 2, 2, 2]))
    >>> round(float(metric.compute()), 4)
    0.4444
"""

from __future__ import annotations

from typing import Any, Literal

from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.clustering.extrinsic import (
    adjusted_mutual_info_score,
    adjusted_rand_score,
    completeness_score,
    fowlkes_mallows_index,
    homogeneity_score,
    mutual_info_score,
    normalized_mutual_info_score,
    rand_score,
    v_measure_score,
)
from torchmetrics_tpu_torch.functional.clustering.utils import _validate_average_method_arg
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class _LabelPairMetric(Metric):
    """Base for metrics over accumulated (preds, target) label streams."""

    is_differentiable = False
    full_state_update = True

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        return {
            "preds": tuple(state["preds"]) + (self._tensor(preds),),
            "target": tuple(state["target"]) + (self._tensor(target),),
        }

    def _labels(self, state: State):
        return dim_zero_cat(state["preds"]), dim_zero_cat(state["target"])


class MutualInfoScore(_LabelPairMetric):
    """Mutual information between cluster assignments."""

    higher_is_better = True
    plot_lower_bound = 0.0

    def _compute(self, state: State) -> Tensor:
        return mutual_info_score(*self._labels(state))


class _AveragedMetric(_LabelPairMetric):
    """Base of the scores normalized by a mean of the two entropies."""

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        average_method: Literal["min", "geometric", "arithmetic", "max"] = "arithmetic",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _validate_average_method_arg(average_method)
        self.average_method = average_method


class AdjustedMutualInfoScore(_AveragedMetric):
    """Chance-adjusted MI."""

    def _compute(self, state: State) -> Tensor:
        return adjusted_mutual_info_score(*self._labels(state), average_method=self.average_method)


class NormalizedMutualInfoScore(_AveragedMetric):
    """Entropy-normalized MI."""

    def _compute(self, state: State) -> Tensor:
        return normalized_mutual_info_score(*self._labels(state), average_method=self.average_method)


class RandScore(_LabelPairMetric):
    """Pair-counting agreement."""

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _compute(self, state: State) -> Tensor:
        return rand_score(*self._labels(state))


class AdjustedRandScore(_LabelPairMetric):
    """Chance-adjusted Rand index."""

    higher_is_better = True
    plot_lower_bound = -0.5
    plot_upper_bound = 1.0

    def _compute(self, state: State) -> Tensor:
        return adjusted_rand_score(*self._labels(state))


class FowlkesMallowsIndex(_LabelPairMetric):
    """Geometric mean of pairwise precision and recall."""

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _compute(self, state: State) -> Tensor:
        return fowlkes_mallows_index(*self._labels(state))


class HomogeneityScore(_LabelPairMetric):
    """Each cluster holds one class."""

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _compute(self, state: State) -> Tensor:
        return homogeneity_score(*self._labels(state))


class CompletenessScore(_LabelPairMetric):
    """Each class lands in one cluster."""

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def _compute(self, state: State) -> Tensor:
        return completeness_score(*self._labels(state))


class VMeasureScore(_LabelPairMetric):
    """Harmonic mean of homogeneity and completeness."""

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, beta: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(beta, float) and beta > 0):
            raise ValueError(f"Argument `beta` should be a positive float. Got {beta}.")
        self.beta = beta

    def _compute(self, state: State) -> Tensor:
        return v_measure_score(*self._labels(state), beta=self.beta)
