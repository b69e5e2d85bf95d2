"""Generic entry points of the stat-scores family.

Counterpart of ``torchmetrics_tpu/functional/classification/_family.py``.
Precision, recall, F-beta, specificity, hamming, NPV and accuracy are each a
named wrapper over the three task functions here and the shared reducer
``_stat_reduce``.
"""

from __future__ import annotations

from typing import Optional

from torch import Tensor

from torchmetrics_tpu_torch.functional.classification._reduce import _stat_reduce
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _as_tensors,
    _binary_format,
    _binary_stat_scores_update,
    _binary_validate_args,
    _check_count,
    _indicator_stat_scores,
    _multiclass_indicators,
    _multiclass_validate_args,
    _multilabel_format,
    _multilabel_stat_scores_update,
    _multilabel_validate_args,
)


def _binary_stat_metric(
    kind: str,
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    beta: float = 1.0,
    zero_division: float = 0.0,
) -> Tensor:
    if validate_args:
        _binary_validate_args(threshold, multidim_average, ignore_index)
    p, t, v = _binary_format(*_as_tensors(preds, target), threshold, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_update(p, t, v, multidim_average)
    return _stat_reduce(kind, tp, fp, tn, fn, average="binary", beta=beta, zero_division=zero_division)


def _multiclass_stat_metric(
    kind: str,
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    beta: float = 1.0,
    zero_division: float = 0.0,
) -> Tensor:
    if validate_args:
        _multiclass_validate_args(num_classes, top_k, average, multidim_average, ignore_index)
    pred_ind, targ_ind, valid = _multiclass_indicators(*_as_tensors(preds, target), num_classes, top_k, ignore_index)
    tp, fp, tn, fn = _indicator_stat_scores(pred_ind, targ_ind, valid, multidim_average)
    return _stat_reduce(kind, tp, fp, tn, fn, average=average, beta=beta, top_k=top_k, zero_division=zero_division)


def _multilabel_stat_metric(
    kind: str,
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    beta: float = 1.0,
    zero_division: float = 0.0,
) -> Tensor:
    if validate_args:
        _multilabel_validate_args(num_labels, threshold, average, multidim_average, ignore_index)
    p, t, v = _multilabel_format(*_as_tensors(preds, target), threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(p, t, v, multidim_average)
    return _stat_reduce(kind, tp, fp, tn, fn, average=average, multilabel=True, beta=beta, zero_division=zero_division)


def _dispatch_stat_metric(
    kind: str,
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    beta: float = 1.0,
    zero_division: float = 0.0,
) -> Tensor:
    task = str(task)
    if task == "binary":
        return _binary_stat_metric(
            kind, preds, target, threshold, multidim_average, ignore_index, validate_args, beta, zero_division
        )
    if task == "multiclass":
        _check_count("num_classes", num_classes)
        return _multiclass_stat_metric(
            kind, preds, target, num_classes, average, top_k, multidim_average, ignore_index,
            validate_args, beta, zero_division,
        )
    if task == "multilabel":
        _check_count("num_labels", num_labels)
        return _multilabel_stat_metric(
            kind, preds, target, num_labels, threshold, average, multidim_average, ignore_index,
            validate_args, beta, zero_division,
        )
    raise ValueError(f"Unsupported task `{task}`.")
