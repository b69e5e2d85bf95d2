"""Shared tp/fp/tn/fn -> score reduction for the stat-scores family.

Counterpart of ``torchmetrics_tpu/functional/classification/_reduce.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.compute import _adjust_weights_safe_divide, _safe_divide


def _stat_reduce(
    kind: str,
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multilabel: bool = False,
    beta: float = 1.0,
    top_k: int = 1,
    zero_division: float = 0.0,
) -> Tensor:
    """Reduce per-class stats to a score.

    ``binary`` applies the formula directly; ``micro`` sums the stats over
    the class axis first; ``macro``/``weighted``/``none`` compute per class,
    then reduce.
    """
    tp, fp, tn, fn = (x.to(torch.float32) for x in (tp, fp, tn, fn))

    def formula(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Tensor:
        if kind == "precision":
            return _safe_divide(tp, tp + fp, zero_division)
        if kind == "recall":
            return _safe_divide(tp, tp + fn, zero_division)
        if kind == "specificity":
            return _safe_divide(tn, tn + fp, zero_division)
        if kind == "npv":
            return _safe_divide(tn, tn + fn, zero_division)
        if kind == "fbeta":
            b2 = beta * beta
            return _safe_divide((1 + b2) * tp, (1 + b2) * tp + b2 * fn + fp, zero_division)
        if kind == "accuracy":
            # pointwise accuracy: binary/multilabel count tn as correct
            if multilabel or average == "binary":
                return _safe_divide(tp + tn, tp + fp + tn + fn, zero_division)
            return _safe_divide(tp, tp + fn, zero_division)
        if kind == "hamming":
            if multilabel or average == "binary":
                return 1.0 - _safe_divide(tp + tn, tp + fp + tn + fn, zero_division)
            return 1.0 - _safe_divide(tp, tp + fn, zero_division)
        raise ValueError(f"Unknown stat reduction kind {kind}")

    if average == "binary":
        return formula(tp, fp, tn, fn)
    if average == "micro":
        tp, fp, tn, fn = tp.sum(-1), fp.sum(-1), tn.sum(-1), fn.sum(-1)
        return formula(tp, fp, tn, fn)
    score = formula(tp, fp, tn, fn)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k=top_k)
