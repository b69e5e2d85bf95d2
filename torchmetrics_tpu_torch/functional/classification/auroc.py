"""AUROC (counterpart of ``torchmetrics_tpu/functional/classification/auroc.py``).

The trapezoidal area under the ROC curve, exact (``thresholds=None``) or
binned, with the binary task's partial area up to ``max_fpr`` (McClish's
standardization). The multiclass and multilabel tasks take the areas of all
columns at once (one batched sort, or the columns of one binned state) where
the JAX package loops over them; each column's area is the one it gives.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.auroc import binary_auroc
    >>> round(float(binary_auroc(torch.tensor([0.1, 0.6, 0.35, 0.8]), torch.tensor([0, 1, 0, 1]))), 4)
    1.0
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _adjust_threshold_arg,
    _binary_prc_format,
    _binned_confmat_multiclass,
    _binned_confmat_multilabel,
    _binned_curve_update,
    _exact_column_curves,
    _multiclass_prc_format,
    _multilabel_prc_format,
    _validate_thresholds,
)
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute_binned,
    _binary_roc_compute_exact,
    _binned_rates,
)
from torchmetrics_tpu_torch.utilities.compute import _auc_compute, _safe_divide
from torchmetrics_tpu_torch.utilities.data import input_device, one_hot, to_tensor


def _partial_auc(fpr: Tensor, tpr: Tensor, max_fpr: float) -> Tensor:
    """McClish-standardized area of the ROC curve up to ``max_fpr``, along the last dim.

    The curve is cut at the first point past ``max_fpr`` (a right
    ``searchsorted``), its last segment interpolated to ``max_fpr``, as in
    the JAX package.
    """
    n = fpr.shape[-1]
    cut = torch.full((*fpr.shape[:-1], 1), max_fpr, dtype=fpr.dtype, device=fpr.device)
    stop = torch.searchsorted(fpr.contiguous(), cut, right=True).clamp(1, n - 1)
    f_lo, f_hi = fpr.gather(-1, stop - 1), fpr.gather(-1, stop)
    t_lo, t_hi = tpr.gather(-1, stop - 1), tpr.gather(-1, stop)
    weight = (max_fpr - f_lo) / torch.clamp(f_hi - f_lo, min=1e-12)
    interp = t_lo + weight * (t_hi - t_lo)
    mask = torch.arange(n, device=fpr.device) < stop
    partial = _auc_compute(torch.where(mask, fpr, max_fpr), torch.where(mask, tpr, interp), direction=1.0)
    min_area = 0.5 * max_fpr**2
    span = torch.tensor(max_fpr - min_area, dtype=partial.dtype, device=partial.device)
    return 0.5 * (1 + _safe_divide(partial - min_area, span))


def _auroc_of(fpr: Tensor, tpr: Tensor, max_fpr: Optional[float] = None) -> Tensor:
    """Area under ROC curves along the last dim (partial up to ``max_fpr`` if given)."""
    if max_fpr is None:
        return _auc_compute(fpr, tpr, direction=1.0)
    return _partial_auc(fpr, tpr, max_fpr)


def _binary_auroc_compute(
    preds: Tensor, target: Tensor, weights: Tensor, thresholds: Optional[Tensor], max_fpr: Optional[float] = None
) -> Tensor:
    if thresholds is None:
        fpr, tpr, _ = _binary_roc_compute_exact(preds, target, weights)
    else:
        fpr, tpr, _ = _binary_roc_compute_binned(_binned_curve_update(preds, target, weights, thresholds), thresholds)
    return _auroc_of(fpr, tpr, max_fpr)


def _column_aurocs(p: Tensor, target: Tensor, w: Tensor) -> Tensor:
    """Exact AUROC of every column of ``p`` (see ``_exact_column_curves``), ``(K,)``."""
    return torch.cat([_auroc_of(fpr, tpr) for _, _, (fpr, tpr, _) in
                      _exact_column_curves(p, target, w, _binary_roc_compute_exact)])


def _binned_aurocs(confmat: Tensor, thresholds: Tensor) -> Tensor:
    """AUROC of every column of a ``(T, K, 2, 2)`` binned state, ``(K,)``."""
    fpr, tpr, _ = _binned_rates(confmat, thresholds)
    return _auroc_of(fpr, tpr)


def _average_aurocs(aucs: Tensor, support: Tensor, average: Optional[str]) -> Tensor:
    if average in (None, "none"):
        return aucs
    if average == "macro":
        return aucs.mean()
    if average == "weighted":
        return (aucs * _safe_divide(support, support.sum())).sum()
    raise ValueError(f"Unknown average {average}")


def binary_auroc(
    preds: Tensor,
    target: Tensor,
    max_fpr: Optional[float] = None,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _validate_thresholds(thresholds)
        if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
            raise ValueError(f"Arguments `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")
    device = input_device(preds)
    p, t, w = _binary_prc_format(to_tensor(preds, device), to_tensor(target, device), ignore_index)
    return _binary_auroc_compute(p, t, w, _adjust_threshold_arg(thresholds, device), max_fpr)


def multiclass_auroc(
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
        if average not in ("macro", "weighted", "none", None):
            raise ValueError(f"Argument `average` must be one of ('macro', 'weighted', 'none', None), got {average}")
    device = input_device(preds)
    p, t, w = _multiclass_prc_format(to_tensor(preds, device), to_tensor(target, device), num_classes, ignore_index)
    thr = _adjust_threshold_arg(thresholds, device)
    if thr is None:
        aucs = _column_aurocs(p, t, w)
    else:
        aucs = _binned_aurocs(_binned_confmat_multiclass(p, t, w, thr, num_classes), thr)
    support = (one_hot(t, num_classes, torch.float32) * w[:, None]).sum(0)
    return _average_aurocs(aucs, support, average)


def multilabel_auroc(
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
        return _binary_auroc_compute(p.reshape(-1), t.reshape(-1), w.reshape(-1), thr)
    aucs = _column_aurocs(p, t, w) if thr is None else _binned_aurocs(_binned_confmat_multilabel(p, t, w, thr), thr)
    return _average_aurocs(aucs, (t * w).sum(0).to(torch.float32), average)


def auroc(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    task = str(task)
    if task == "binary":
        return binary_auroc(preds, target, max_fpr, thresholds, ignore_index, validate_args)
    if task == "multiclass":
        return multiclass_auroc(preds, target, num_classes, average, thresholds, ignore_index, validate_args)
    if task == "multilabel":
        return multilabel_auroc(preds, target, num_labels, average, thresholds, ignore_index, validate_args)
    raise ValueError(f"Unsupported task `{task}` passed to `auroc`.")
