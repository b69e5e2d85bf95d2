"""Word and character error rates as classes: WER, CER, MER, WIL, WIP and the edit distance
(counterpart of ``torchmetrics_tpu/text/asr.py``).

Every class keeps float32 scalar sums on its device; ``EditDistance`` keeps
int32 sums, or with ``reduction='none'`` a cat list of int32 distances.

Example::

    >>> from torchmetrics_tpu_torch.text import WordErrorRate
    >>> metric = WordErrorRate(device="cpu")
    >>> metric.update(["this is the prediction"], ["this is the reference"])
    >>> round(float(metric.compute()), 4)
    0.25
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.text.asr import (
    _cer_update,
    _edit_update,
    _mer_update,
    _wer_update,
    _wil_wip_update,
)
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class _ErrorRateMetric(Metric):
    """Base of the (errors, total) ratios."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    _update_fn = None  # set by subclass

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def _update(self, state: State, preds: Union[str, List[str]], target: Union[str, List[str]]) -> State:
        errors, total = type(self)._update_fn(preds, target, device=self.device)
        return {"errors": state["errors"] + errors, "total": state["total"] + total}

    def _compute(self, state: State) -> Tensor:
        return state["errors"] / state["total"]


class WordErrorRate(_ErrorRateMetric):
    """WER."""

    _update_fn = staticmethod(_wer_update)


class CharErrorRate(_ErrorRateMetric):
    """CER.

    Example::

        >>> from torchmetrics_tpu_torch.text import CharErrorRate
        >>> metric = CharErrorRate(device="cpu")
        >>> metric.update(["this is the prediction"], ["this is the reference"])
        >>> round(float(metric.compute()), 4)
        0.381
    """

    _update_fn = staticmethod(_cer_update)


class MatchErrorRate(_ErrorRateMetric):
    """MER."""

    _update_fn = staticmethod(_mer_update)


class _WordInfoBase(Metric):
    is_differentiable = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("hits", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("target_total", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("preds_total", torch.zeros(()), dist_reduce_fx="sum")

    def _update(self, state: State, preds: Union[str, List[str]], target: Union[str, List[str]]) -> State:
        hits, tt, pt = _wil_wip_update(preds, target, device=self.device)
        return {
            "hits": state["hits"] + hits,
            "target_total": state["target_total"] + tt,
            "preds_total": state["preds_total"] + pt,
        }

    def _wip(self, state: State) -> Tensor:
        return (state["hits"] / state["target_total"]) * (state["hits"] / state["preds_total"])


class WordInfoPreserved(_WordInfoBase):
    """WIP."""

    higher_is_better = True

    def _compute(self, state: State) -> Tensor:
        return self._wip(state)


class WordInfoLost(_WordInfoBase):
    """WIL."""

    higher_is_better = False

    def _compute(self, state: State) -> Tensor:
        return 1.0 - self._wip(state)


class EditDistance(Metric):
    """Char-level Levenshtein distance: int32 sums (mean or sum), or the distances with ``reduction='none'``."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, substitution_cost: int = 1, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(substitution_cost, int) and substitution_cost >= 0):
            raise ValueError(
                f"Expected argument `substitution_cost` to be a positive integer, but got {substitution_cost}"
            )
        if reduction not in ("mean", "sum", "none", None):
            raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")
        self.substitution_cost = substitution_cost
        self.reduction = reduction
        if reduction in ("none", None):
            self.add_state("values", [], dist_reduce_fx="cat")
        else:
            # int32: edit distances and sentence counts are integers; float32 sums stall at 2**24
            self.add_state("values", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum",
                           value_range=(0.0, float("inf")))
            self.add_state("count", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum",
                           value_range=(0.0, float("inf")))

    def _update(self, state: State, preds: Union[str, List[str]], target: Union[str, List[str]]) -> State:
        dists = _edit_update(preds, target, self.substitution_cost)
        if self.reduction in ("none", None):
            return {"values": state["values"] + (torch.tensor(dists, dtype=torch.int32, device=self.device),)}
        return {"values": state["values"] + int(sum(dists)), "count": state["count"] + len(dists)}

    def _compute(self, state: State) -> Tensor:
        if self.reduction in ("none", None):
            return dim_zero_cat(state["values"]) if state["values"] else torch.zeros(0, device=self.device)
        if self.reduction == "sum":
            return state["values"]
        return state["values"] / torch.clamp_min(state["count"], 1.0)
