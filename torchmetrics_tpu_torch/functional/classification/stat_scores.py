"""Stat scores (tp/fp/tn/fn), the root of the classification tower.

Counterpart of ``torchmetrics_tpu/functional/classification/stat_scores.py``.
Everything is expressed over one-hot indicator tensors with a validity mask,
as in the JAX package:

    pred_ind:  (N, C, S) 0/1   (top-k may set several 1s per sample)
    targ_ind:  (N, C, S) 0/1   one-hot target
    valid:     (N, 1, S) 0/1   ignore_index mask

The indicator sums are float32, as in the JAX package, and exact below 2**24
elements per class per batch.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.stat_scores import multiclass_stat_scores
    >>> preds = torch.tensor([0, 1, 2, 1])
    >>> target = torch.tensor([0, 1, 2, 2])
    >>> multiclass_stat_scores(preds, target, num_classes=3, average="micro")  # tp, fp, tn, fn, support
    tensor([3, 1, 7, 1, 4], dtype=torch.int32)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.data import input_device, one_hot, select_topk, to_tensor


def _multiclass_validate_args(num_classes, top_k, average, multidim_average, ignore_index) -> None:
    if not (isinstance(num_classes, int) and num_classes > 1):
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if not (isinstance(top_k, int) and top_k > 0):
        raise ValueError(f"Expected argument `top_k` to be an integer larger than 0, but got {top_k}")
    if top_k > num_classes:
        raise ValueError(
            f"Expected argument `top_k` to be smaller or equal to `num_classes` but got {top_k} and {num_classes}"
        )
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('micro', 'macro', 'weighted', 'none', None), but got {average}"
        )
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ('global', 'samplewise'), but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _multiclass_indicators(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    top_k: int = 1,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Build ``(pred_ind, targ_ind, valid)`` of shape (N, C, S) / (N, 1, S).

    ``preds`` is either int labels (N, ...) or float scores (N, C, ...);
    ``target`` is int labels (N, ...). Extra dims are flattened into S.
    """
    n = target.shape[0]
    target_flat = target.reshape(n, -1)  # (N, S)
    s = target_flat.shape[1]

    valid = torch.ones((n, 1, s), dtype=torch.float32, device=target.device)
    if ignore_index is not None:
        ignored = target_flat == ignore_index
        valid = torch.where(ignored[:, None, :], 0.0, valid)
        target_flat = torch.where(ignored, 0, target_flat)
    targ_ind = one_hot(target_flat, num_classes, torch.float32, axis=1)  # (N, C, S)

    if preds.is_floating_point():
        scores = preds.reshape(n, num_classes, s)
        pred_ind = select_topk(scores, topk=top_k, dim=1).to(torch.float32)
    else:
        pred_ind = one_hot(preds.reshape(n, -1), num_classes, torch.float32, axis=1)
    return pred_ind, targ_ind, valid


def _indicator_stat_scores(
    pred_ind: Tensor,
    targ_ind: Tensor,
    valid: Tensor,
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(tp, fp, tn, fn) per class: (C,) for global, (N, C) for samplewise."""
    axes = (0, 2) if multidim_average == "global" else (2,)
    tp = (pred_ind * targ_ind * valid).sum(dim=axes)
    fp = (pred_ind * (1 - targ_ind) * valid).sum(dim=axes)
    fn = ((1 - pred_ind) * targ_ind * valid).sum(dim=axes)
    tn = ((1 - pred_ind) * (1 - targ_ind) * valid).sum(dim=axes)
    return tp, fp, tn, fn


def multiclass_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """int32 tp/fp/tn/fn/support for multiclass tasks.

    Output shape: (5,) for micro, (C, 5) for macro/weighted/none under global
    averaging; N is prepended for samplewise.
    """
    if validate_args:
        _multiclass_validate_args(num_classes, top_k, average, multidim_average, ignore_index)
    device = input_device(preds)
    preds, target = to_tensor(preds, device), to_tensor(target, device)
    pred_ind, targ_ind, valid = _multiclass_indicators(preds, target, num_classes, top_k, ignore_index)
    tp, fp, tn, fn = _indicator_stat_scores(pred_ind, targ_ind, valid, multidim_average)
    if average == "micro":
        tp, fp, tn, fn = tp.sum(-1), fp.sum(-1), tn.sum(-1), fn.sum(-1)
    return torch.stack([tp, fp, tn, fn, tp + fn], dim=-1).to(torch.int32)
