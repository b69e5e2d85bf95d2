"""Average precision (counterpart of ``torchmetrics_tpu/functional/classification/average_precision.py``).

AP = sum_n (R_n - R_{n-1}) P_n over the precision-recall curve, exact
(``thresholds=None``) or binned, for the three tasks. The multiclass and
multilabel exact paths sort all columns' scores in one batched sort
(``_exact_column_curves``) where the JAX package loops over the columns.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.average_precision import multiclass_average_precision
    >>> probs = torch.tensor([[0.8, 0.1, 0.1], [0.2, 0.7, 0.1], [0.1, 0.2, 0.7], [0.3, 0.4, 0.3]])
    >>> round(float(multiclass_average_precision(probs, torch.tensor([0, 1, 1, 2]), num_classes=3)), 4)
    0.7778
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _adjust_threshold_arg,
    _binary_precision_recall_curve_compute_binned,
    _binary_precision_recall_curve_compute_exact,
    _binary_prc_format,
    _binned_confmat_multiclass,
    _binned_confmat_multilabel,
    _binned_curve_update,
    _exact_column_curves,
    _multiclass_prc_format,
    _multilabel_prc_format,
    _validate_thresholds,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import input_device, to_tensor


def _ap_from_curve(precision: Tensor, recall: Tensor, dim: int = -1) -> Tensor:
    """AP along ``dim`` of curves in ascending-threshold order (recall
    descending) that end in the (1, 0) point: each recall gap is weighted by
    the precision of its higher-recall end (sklearn's step function)."""
    n = precision.shape[dim]
    gaps = recall.narrow(dim, 1, n - 1) - recall.narrow(dim, 0, n - 1)
    return -(gaps * precision.narrow(dim, 0, n - 1)).sum(dim)


def _binary_ap_compute(preds: Tensor, target: Tensor, weights: Tensor, thresholds: Optional[Tensor]) -> Tensor:
    if thresholds is None:
        precision, recall, _ = _binary_precision_recall_curve_compute_exact(preds, target, weights)
        return _ap_from_curve(precision, recall)
    confmat = _binned_curve_update(preds, target, weights, thresholds)
    precision, recall, _ = _binary_precision_recall_curve_compute_binned(confmat, thresholds)
    return _ap_from_curve(precision, recall, dim=0)


def _column_aps(p: Tensor, target: Tensor, w: Tensor) -> Tensor:
    """Exact AP of every column of ``p`` (see ``_exact_column_curves``), ``(K,)``."""
    return torch.cat([_ap_from_curve(pr, rc) for _, _, (pr, rc, _) in _exact_column_curves(p, target, w)])


def _multiclass_exact_ap(p: Tensor, target: Tensor, w: Tensor, num_classes: int) -> Tuple[Tensor, Tensor]:
    """Per-class exact APs and float32 supports ``sum(onehot * w)``, ``(C,)`` each."""
    aps = _column_aps(p, target, w)
    onehot = (target[:, None] == torch.arange(num_classes, device=p.device)[None, :]).to(torch.float32)
    return aps, (onehot * w[:, None]).sum(0)


def _multiclass_binned_ap(confmat: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-class APs and int supports of a ``(T, C, 2, 2)`` binned state."""
    precision, recall, _ = _binary_precision_recall_curve_compute_binned(confmat, thresholds)
    return _ap_from_curve(precision, recall, dim=0), confmat[0, :, 1, :].sum(-1)


def _average(aps: Tensor, support: Tensor, average: Optional[str]) -> Tensor:
    if average in (None, "none"):
        return aps
    if average == "macro":
        return aps.mean()
    if average == "weighted":
        return (aps * _safe_divide(support, support.sum())).sum()
    raise ValueError(f"Argument `average` must be one of ('macro', 'weighted', 'none', None), got {average}")


def multiclass_average_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _validate_thresholds(thresholds)
    device = input_device(preds)
    p, t, w = _multiclass_prc_format(to_tensor(preds, device), to_tensor(target, device), num_classes, ignore_index)
    thr = _adjust_threshold_arg(thresholds, device)
    if thr is None:
        aps, support = _multiclass_exact_ap(p, t, w, num_classes)
    else:
        aps, _ = _multiclass_binned_ap(_binned_confmat_multiclass(p, t, w, thr, num_classes), thr)
        onehot = (t[:, None] == torch.arange(num_classes, device=device)[None, :]).to(torch.float32)
        support = (onehot * w[:, None]).sum(0)
    return _average(aps, support, average)


def binary_average_precision(
    preds: Tensor,
    target: Tensor,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _validate_thresholds(thresholds)
    device = input_device(preds)
    p, t, w = _binary_prc_format(to_tensor(preds, device), to_tensor(target, device), ignore_index)
    return _binary_ap_compute(p, t, w, _adjust_threshold_arg(thresholds, device))


def multilabel_average_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _validate_thresholds(thresholds)
    device = input_device(preds)
    p, t, w = _multilabel_prc_format(to_tensor(preds, device), to_tensor(target, device), num_labels, ignore_index)
    thr = _adjust_threshold_arg(thresholds, device)
    if average == "micro":
        return _binary_ap_compute(p.reshape(-1), t.reshape(-1), w.reshape(-1), thr)
    if thr is None:
        aps = _column_aps(p, t, w)
    else:
        aps, _ = _multiclass_binned_ap(_binned_confmat_multilabel(p, t, w, thr), thr)
    return _average(aps, (t * w).sum(0).to(torch.float32), average)


def average_precision(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    task = str(task)
    if task == "binary":
        return binary_average_precision(preds, target, thresholds, ignore_index, validate_args)
    if task == "multiclass":
        return multiclass_average_precision(preds, target, num_classes, average, thresholds, ignore_index, validate_args)
    if task == "multilabel":
        return multilabel_average_precision(preds, target, num_labels, average, thresholds, ignore_index, validate_args)
    raise ValueError(f"Unsupported task `{task}` passed to `average_precision`.")
