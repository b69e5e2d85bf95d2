"""Stat scores (tp/fp/tn/fn), the root of the classification tower.

Counterpart of ``torchmetrics_tpu/functional/classification/stat_scores.py``.
Multiclass inputs are expressed over one-hot indicator tensors with a
validity mask, as in the JAX package:

    pred_ind:  (N, C, S) 0/1   (top-k may set several 1s per sample)
    targ_ind:  (N, C, S) 0/1   one-hot target
    valid:     (N, 1, S) 0/1   ignore_index mask

Binary and multilabel inputs become 0/1 predictions (a sigmoid first when
any score of the whole tensor lies outside [0, 1], then ``> threshold``), 0/1
targets and the same validity mask. The sums are float32, as in the JAX
package, and exact below 2**24 elements per class per batch.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.stat_scores import multiclass_stat_scores
    >>> preds = torch.tensor([0, 1, 2, 1])
    >>> target = torch.tensor([0, 1, 2, 2])
    >>> multiclass_stat_scores(preds, target, num_classes=3, average="micro")  # tp, fp, tn, fn, support
    tensor([3, 1, 7, 1, 4], dtype=torch.int32)
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.compute import normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.data import input_device, one_hot, select_topk, to_tensor


def _as_tensors(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """A functional metric's inputs as tensors on the device of ``preds``."""
    device = input_device(preds)
    return to_tensor(preds, device), to_tensor(target, device)


def _binary_format(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Binary inputs -> ``(pred01, target01, valid)``, all of the target's shape.

    Float scores go through a sigmoid when any element of the whole tensor
    lies outside [0, 1], then ``> threshold``.
    """
    valid = torch.ones(target.shape, dtype=torch.float32, device=target.device)
    if ignore_index is not None:
        ignored = target == ignore_index
        valid = torch.where(ignored, 0.0, valid)
        target = torch.where(ignored, 0, target)
    if preds.is_floating_point():
        preds = normalize_logits_if_needed(preds, "sigmoid") > threshold
    return preds.to(torch.int32), target.to(torch.int32), valid


def _stack_stats(stats: Tuple[Tensor, Tensor, Tensor, Tensor], average: Optional[str] = None) -> Tensor:
    """int32 tp, fp, tn, fn and support (tp + fn) on the last dim; summed over the classes for micro."""
    if average == "micro":
        stats = tuple(x.sum(-1) for x in stats)
    tp, fp, tn, fn = stats
    return torch.stack([tp, fp, tn, fn, tp + fn], dim=-1).to(torch.int32)


def _sum_over(x: Tensor, dims: Tuple[int, ...]) -> Tensor:
    # ``jnp.sum(x, axis=())`` reduces nothing; torch's ``sum(dim=())`` reduces everything
    return x.sum(dim=dims) if dims else x


def _binary_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    valid: Tensor,
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """float32 ``(tp, fp, tn, fn)``: scalars for global, ``(N,)`` for samplewise."""
    p, t, v = preds.to(torch.float32), target.to(torch.float32), valid
    dims = tuple(range(p.ndim)) if multidim_average == "global" else tuple(range(1, p.ndim))
    tp = _sum_over(p * t * v, dims)
    fp = _sum_over(p * (1 - t) * v, dims)
    tn = _sum_over((1 - p) * (1 - t) * v, dims)
    fn = _sum_over((1 - p) * t * v, dims)
    return tp, fp, tn, fn


def binary_stat_scores(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """int32 tp/fp/tn/fn/support for binary tasks, stacked along the last dim."""
    if validate_args:
        _binary_validate_args(threshold, multidim_average, ignore_index)
    p, t, v = _binary_format(*_as_tensors(preds, target), threshold, ignore_index)
    return _stack_stats(_binary_stat_scores_update(p, t, v, multidim_average))


def _binary_validate_args(threshold, multidim_average, ignore_index) -> None:
    if not (isinstance(threshold, float) and 0 <= threshold <= 1):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ('global', 'samplewise'), but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


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
    pred_ind, targ_ind, valid = _multiclass_indicators(*_as_tensors(preds, target), num_classes, top_k, ignore_index)
    return _stack_stats(_indicator_stat_scores(pred_ind, targ_ind, valid, multidim_average), average)


def _multilabel_validate_args(num_labels, threshold, average, multidim_average, ignore_index) -> None:
    if not (isinstance(num_labels, int) and num_labels > 1):
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    _binary_validate_args(threshold, multidim_average, ignore_index)
    if average not in ("micro", "macro", "weighted", "none", None):
        raise ValueError(
            f"Expected argument `average` to be one of ('micro', 'macro', 'weighted', 'none', None), but got {average}"
        )


# the multilabel inputs (N, L, ...) are formatted as the binary ones, elementwise
_multilabel_format = _binary_format


def _multilabel_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    valid: Tensor,
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """float32 ``(tp, fp, tn, fn)`` per label: ``(L,)`` global or ``(N, L)`` samplewise."""
    n, n_labels = preds.shape[0], preds.shape[1]
    p = preds.to(torch.float32).reshape(n, n_labels, -1)
    t = target.to(torch.float32).reshape(n, n_labels, -1)
    v = valid.reshape(n, n_labels, -1)
    axes = (0, 2) if multidim_average == "global" else (2,)
    tp = (p * t * v).sum(dim=axes)
    fp = (p * (1 - t) * v).sum(dim=axes)
    fn = ((1 - p) * t * v).sum(dim=axes)
    tn = ((1 - p) * (1 - t) * v).sum(dim=axes)
    return tp, fp, tn, fn


def multilabel_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """int32 tp/fp/tn/fn/support for multilabel tasks."""
    if validate_args:
        _multilabel_validate_args(num_labels, threshold, average, multidim_average, ignore_index)
    p, t, v = _multilabel_format(*_as_tensors(preds, target), threshold, ignore_index)
    return _stack_stats(_multilabel_stat_scores_update(p, t, v, multidim_average), average)


def _check_count(name: str, value: Any) -> None:
    if not isinstance(value, int):
        raise ValueError(f"`{name}` is expected to be `int` but `{type(value)}` was passed.`")


def stat_scores(
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
) -> Tensor:
    """Task dispatch over the three ``*_stat_scores``."""
    task = str(task)
    if task == "binary":
        return binary_stat_scores(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == "multiclass":
        _check_count("num_classes", num_classes)
        return multiclass_stat_scores(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    if task == "multilabel":
        _check_count("num_labels", num_labels)
        return multilabel_stat_scores(
            preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
        )
    raise ValueError(f"Unsupported task `{task}` passed to `stat_scores`.")
