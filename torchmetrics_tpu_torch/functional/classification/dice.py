"""Dice score (counterpart of ``torchmetrics_tpu/functional/classification/dice.py``).

Dice is F1 on the stat-scores decomposition: ``2 tp / (2 tp + fp + fn)``.
Plain PyTorch on any device.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.dice import dice
    >>> round(float(dice(torch.tensor([2, 0, 2, 1]), torch.tensor([1, 0, 2, 1]), average="micro", num_classes=3)), 4)
    0.75
"""

from __future__ import annotations

from typing import Optional

from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _as_tensors,
    _indicator_stat_scores,
    _multiclass_indicators,
)
from torchmetrics_tpu_torch.utilities.compute import _adjust_weights_safe_divide, _safe_divide


def _dice_reduce(tp: Tensor, fp: Tensor, fn: Tensor, average: Optional[str]) -> Tensor:
    if average == "micro":
        tp, fp, fn = tp.sum(), fp.sum(), fn.sum()
        return _safe_divide(2 * tp, 2 * tp + fp + fn)
    score = _safe_divide(2 * tp, 2 * tp + fp + fn)
    return _adjust_weights_safe_divide(score, average, False, tp, fp, fn)


def dice(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    average: Optional[str] = "micro",
    ignore_index: Optional[int] = None,
    top_k: int = 1,
) -> Tensor:
    """Dice score from multiclass stat scores (labels ``(N, ...)`` or scores ``(N, C, ...)``)."""
    if num_classes is None:
        raise ValueError("`num_classes` must be provided for the TPU-native dice (static shapes).")
    pred_ind, targ_ind, valid = _multiclass_indicators(*_as_tensors(preds, target), num_classes, top_k, ignore_index)
    tp, fp, _, fn = _indicator_stat_scores(pred_ind, targ_ind, valid, "global")
    return _dice_reduce(tp, fp, fn, average)
