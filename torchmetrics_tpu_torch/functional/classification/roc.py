"""ROC curves (counterpart of ``torchmetrics_tpu/functional/classification/roc.py``).

Exact (``thresholds=None``): the tie-collapsed cumulative counts of
``_binary_clf_curve`` with the (0, 0) origin prepended; binned: the rates of
the ``(T, ..., 2, 2)`` confusion state, flipped so that the false positive
rate rises. Both work on batches of curves: the last dim (exact) or the dims
between T and the 2x2 cell (binned) hold the classes or labels, where the
JAX package loops over them.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.roc import binary_roc
    >>> fpr, tpr, thresholds = binary_roc(torch.tensor([0.1, 0.6, 0.35, 0.8]), torch.tensor([0, 1, 0, 1]))
    >>> fpr
    tensor([0.0000, 0.0000, 0.0000, 0.5000, 1.0000])
    >>> tpr
    tensor([0.0000, 0.5000, 1.0000, 1.0000, 1.0000])
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _adjust_threshold_arg,
    _binary_clf_curve,
    _binary_prc_format,
    _binned_confmat_multiclass,
    _binned_confmat_multilabel,
    _binned_curve_update,
    _column_curve_lists,
    _multiclass_prc_format,
    _multilabel_prc_format,
    _validate_thresholds,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import input_device, to_tensor


def _binary_roc_compute_exact(preds: Tensor, target: Tensor, weights: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Exact ``(fpr, tpr, thresholds)`` along the last dim, ``N + 1`` points
    from the (0, 0) origin, whose threshold is ``1 + 0 * max score`` as in JAX."""
    fps, tps, thresholds = _binary_clf_curve(preds, target, weights)
    zero = torch.zeros_like(tps[..., :1])
    tps = torch.cat([zero, tps], dim=-1)
    fps = torch.cat([zero, fps], dim=-1)
    thresholds = torch.cat([1.0 + thresholds[..., :1] * 0, thresholds], dim=-1)
    return _safe_divide(fps, fps[..., -1:]), _safe_divide(tps, tps[..., -1:]), thresholds


def _binary_roc_compute_binned(confmat: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """``(fpr, tpr, thresholds)`` from a ``(T, ..., 2, 2)`` binned confusion state.

    Flipped along T so that fpr rises (thresholds descending). The JAX
    version takes one ``(T, 2, 2)`` curve; any batch dims between T and the
    2x2 cell (the classes) are kept, so all curves come out in one pass.
    """
    tp = confmat[..., 1, 1]
    fp = confmat[..., 0, 1]
    fn = confmat[..., 1, 0]
    tn = confmat[..., 0, 0]
    tpr = torch.flip(_safe_divide(tp, tp + fn), (0,))
    fpr = torch.flip(_safe_divide(fp, fp + tn), (0,))
    return fpr, tpr, torch.flip(thresholds, (0,))


def _binned_rates(confmat: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """``(fpr, tpr)`` ``(C, T)`` of a ``(T, C, 2, 2)`` state and the flipped
    thresholds, as the multiclass and multilabel ROC return them."""
    fpr, tpr, thr = _binary_roc_compute_binned(confmat, thresholds)
    return fpr.T, tpr.T, thr


def binary_roc(
    preds: Tensor,
    target: Tensor,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    if validate_args:
        _validate_thresholds(thresholds)
    device = input_device(preds)
    p, t, w = _binary_prc_format(to_tensor(preds, device), to_tensor(target, device), ignore_index)
    thr = _adjust_threshold_arg(thresholds, device)
    if thr is None:
        return _binary_roc_compute_exact(p, t, w)
    return _binary_roc_compute_binned(_binned_curve_update(p, t, w, thr), thr)


def multiclass_roc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Exact: per-class lists of curves; binned: ``(C, T)`` fpr and tpr and the flipped thresholds."""
    if validate_args:
        _validate_thresholds(thresholds)
    device = input_device(preds)
    p, t, w = _multiclass_prc_format(to_tensor(preds, device), to_tensor(target, device), num_classes, ignore_index)
    thr = _adjust_threshold_arg(thresholds, device)
    if thr is None:
        return _column_curve_lists(p, t, w, _binary_roc_compute_exact)
    return _binned_rates(_binned_confmat_multiclass(p, t, w, thr, num_classes), thr)


def multilabel_roc(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Exact: per-label lists of curves; binned: ``(L, T)`` fpr and tpr and the flipped thresholds."""
    if validate_args:
        _validate_thresholds(thresholds)
    device = input_device(preds)
    p, t, w = _multilabel_prc_format(to_tensor(preds, device), to_tensor(target, device), num_labels, ignore_index)
    thr = _adjust_threshold_arg(thresholds, device)
    if thr is None:
        return _column_curve_lists(p, t, w, _binary_roc_compute_exact)
    return _binned_rates(_binned_confmat_multilabel(p, t, w, thr), thr)


def roc(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    task = str(task)
    if task == "binary":
        return binary_roc(preds, target, thresholds, ignore_index, validate_args)
    if task == "multiclass":
        return multiclass_roc(preds, target, num_classes, thresholds, ignore_index, validate_args)
    if task == "multilabel":
        return multilabel_roc(preds, target, num_labels, thresholds, ignore_index, validate_args)
    raise ValueError(f"Unsupported task `{task}` passed to `roc`.")
