"""Nominal-association metric classes (counterpart of ``torchmetrics_tpu/nominal/nominal.py``).

The χ² family accumulates a float32 ``(num_classes, num_classes)``
contingency table, sum-reduced: one ``confmat_multiclass`` launch an update
on the card, whose int32 counts are added into it (four such metrics with one
NaN strategy form one compute group, one launch a batch). FleissKappa keeps
the per-sample int32 category counts as a cat list.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.nominal import CramersV
    >>> metric = CramersV(num_classes=3, device="cpu")
    >>> metric.update(torch.tensor([0, 1, 2, 1, 0, 2, 0, 1]), torch.tensor([0, 1, 2, 2, 0, 1, 0, 1]))
    >>> round(float(metric.compute()), 4)
    0.5652
"""

from __future__ import annotations

from typing import Any, Literal, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.nominal.contingency import (
    _cramers_v_compute,
    _nominal_confmat_update,
    _pearsons_contingency_coefficient_compute,
    _theils_u_compute,
    _tschuprows_t_compute,
)
from torchmetrics_tpu_torch.functional.nominal.fleiss_kappa import _fleiss_kappa_compute, _fleiss_kappa_update
from torchmetrics_tpu_torch.functional.nominal.utils import _nominal_input_validation
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

NanStrategy = Literal["replace", "drop"]


class _ContingencyMetric(Metric):
    """Base: (C, C) contingency-table state, statistic evaluated at compute."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_classes: int,
        nan_strategy: NanStrategy = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_classes, int) and num_classes > 0):
            raise ValueError(f"Argument `num_classes` must be a positive integer, got {num_classes}")
        _nominal_input_validation(nan_strategy, nan_replace_value)
        self.num_classes = num_classes
        self.nan_strategy = nan_strategy
        self.nan_replace_value = nan_replace_value
        self.add_state("confmat", torch.zeros((num_classes, num_classes)), dist_reduce_fx="sum")

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        preds, target = torch.as_tensor(preds, device=self.device), torch.as_tensor(target, device=self.device)
        cm = _nominal_confmat_update(preds, target, self.num_classes, self.nan_strategy, self.nan_replace_value)
        return {"confmat": state["confmat"] + cm}


class CramersV(_ContingencyMetric):
    """Cramér's V association."""

    def __init__(
        self,
        num_classes: int,
        bias_correction: bool = True,
        nan_strategy: NanStrategy = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes, nan_strategy, nan_replace_value, **kwargs)
        self.bias_correction = bias_correction

    def _compute(self, state: State) -> Tensor:
        return _cramers_v_compute(state["confmat"], self.bias_correction)


class TschuprowsT(_ContingencyMetric):
    """Tschuprow's T association."""

    def __init__(
        self,
        num_classes: int,
        bias_correction: bool = True,
        nan_strategy: NanStrategy = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes, nan_strategy, nan_replace_value, **kwargs)
        self.bias_correction = bias_correction

    def _compute(self, state: State) -> Tensor:
        return _tschuprows_t_compute(state["confmat"], self.bias_correction)


class PearsonsContingencyCoefficient(_ContingencyMetric):
    """Pearson's contingency coefficient."""

    def _compute(self, state: State) -> Tensor:
        return _pearsons_contingency_coefficient_compute(state["confmat"])


class TheilsU(_ContingencyMetric):
    """Theil's U uncertainty coefficient; asymmetric.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import TheilsU
        >>> metric = TheilsU(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 1, 0, 2, 0, 1]), torch.tensor([0, 1, 2, 2, 0, 1, 0, 1]))
        >>> round(float(metric.compute()), 4)
        0.6193
    """

    def _compute(self, state: State) -> Tensor:
        return _theils_u_compute(state["confmat"])


class FleissKappa(Metric):
    """Fleiss' kappa inter-rater agreement."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, mode: Literal["counts", "probs"] = "counts", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if mode not in ("counts", "probs"):
            raise ValueError("Argument ``mode`` must be one of 'counts' or 'probs'.")
        self.mode = mode
        self.add_state("counts", [], dist_reduce_fx="cat")

    def _update(self, state: State, ratings: Tensor) -> State:
        counts = _fleiss_kappa_update(self._tensor(ratings), self.mode)
        return {"counts": tuple(state["counts"]) + (counts,)}

    def _compute(self, state: State) -> Tensor:
        return _fleiss_kappa_compute(dim_zero_cat(state["counts"]))
