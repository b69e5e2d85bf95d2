"""KL divergence and cosine similarity (counterpart of ``torchmetrics_tpu/regression/distribution.py``)."""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.regression.basic import _cosine_similarity_compute, _kl_divergence_update
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class KLDivergence(Metric):
    """``KL(p || q)`` of row distributions: the mean or sum over rows (sum states), or every row (a cat state)."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, log_prob: bool = False, reduction: str = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(log_prob, bool):
            raise TypeError(f"Expected argument `log_prob` to be bool but got {log_prob}")
        allowed = ("mean", "sum", "none", None)
        if reduction not in allowed:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed} but got {reduction}")
        self.log_prob = log_prob
        self.reduction = reduction
        if reduction in ("mean", "sum"):
            self.add_state("measures", torch.zeros(()), dist_reduce_fx="sum")
        else:
            self.add_state("measures", [], dist_reduce_fx="cat")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def _update(self, state: State, p: Tensor, q: Tensor) -> State:
        measures, n = _kl_divergence_update(self._tensor(p), self._tensor(q), self.log_prob)
        if self.reduction in ("mean", "sum"):
            return {"measures": state["measures"] + measures.sum(), "total": state["total"] + n}
        return {"measures": state["measures"] + (measures,), "total": state["total"] + n}

    def _compute(self, state: State) -> Tensor:
        if self.reduction == "mean":
            return state["measures"] / torch.clamp(state["total"], min=1.0)
        if self.reduction == "sum":
            return state["measures"]
        return dim_zero_cat(state["measures"])


class CosineSimilarity(Metric):
    """Cosine similarity of row pairs, reduced over the rows (``cat`` states).

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import CosineSimilarity
        >>> metric = CosineSimilarity(reduction="mean", device="cpu")
        >>> metric.update(torch.tensor([[1.0, 2.0, 3.0]]), torch.tensor([[1.0, 2.0, 4.0]]))
        >>> round(float(metric.compute()), 4)
        0.9915
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, reduction: str = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        allowed = ("sum", "mean", "none", None)
        if reduction not in allowed:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed} but got {reduction}")
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        return {
            "preds": state["preds"] + (self._tensor(preds).to(torch.float32),),
            "target": state["target"] + (self._tensor(target).to(torch.float32),),
        }

    def _compute(self, state: State) -> Tensor:
        return _cosine_similarity_compute(dim_zero_cat(state["preds"]), dim_zero_cat(state["target"]), self.reduction)
