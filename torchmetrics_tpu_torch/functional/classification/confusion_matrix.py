"""Confusion matrices (counterpart of ``torchmetrics_tpu/functional/classification/confusion_matrix.py``).

The counts are the JAX package's scatter-add of ``target * C + pred``, with
its int32 wrap and drop rules (``kernels/confmat.py``), as exact int32
counts. The multiclass update of a CUDA tensor is one call of the
``confmat_multiclass`` CUDA kernel (``csrc/confmat.cu``), the argmax, the
index arithmetic and the add in one pass; on the CPU it is the kernel's plain
version. The binary and multilabel updates are PyTorch ops on any device.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.confusion_matrix import multiclass_confusion_matrix
    >>> multiclass_confusion_matrix(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 0]), num_classes=3)
    tensor([[1, 1, 0],
            [0, 1, 0],
            [0, 0, 1]], dtype=torch.int32)
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _as_tensors,
    _binary_format,
    _check_count,
    _multilabel_format,
    _multilabel_stat_scores_update,
)
from torchmetrics_tpu_torch.kernels.confmat import _confmat_multiclass_plain, _pair_counts, confmat_multiclass
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import input_device

_ALLOWED_NORMALIZE = ("true", "pred", "all", "none", None)
_KERNEL_INT_TYPES = (torch.int32, torch.int64)


def _confusion_matrix_validate_args(
    normalize: Optional[str],
    ignore_index: Optional[int],
    threshold: Optional[float] = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
) -> None:
    if normalize not in _ALLOWED_NORMALIZE:
        raise ValueError(f"Argument `normalize` needs to be one of {_ALLOWED_NORMALIZE}, but got {normalize}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    if threshold is not None and not (isinstance(threshold, float) and 0 <= threshold <= 1):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    if num_classes is not None and not (isinstance(num_classes, int) and num_classes > 1):
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if num_labels is not None and not (isinstance(num_labels, int) and num_labels > 1):
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")


def _normalize_confmat(confmat: Tensor, normalize: Optional[str]) -> Tensor:
    """float32 rates over the true rows, the predicted columns or all cells; int32 counts for None."""
    if normalize is None or normalize == "none":
        return confmat.to(torch.int32)
    confmat = confmat.to(torch.float32)
    if normalize == "true":
        return _safe_divide(confmat, confmat.sum(dim=-1, keepdim=True))
    if normalize == "pred":
        return _safe_divide(confmat, confmat.sum(dim=-2, keepdim=True))
    if normalize == "all":
        return _safe_divide(confmat, confmat.sum(dim=(-2, -1), keepdim=True))
    raise ValueError(
        f"Argument `normalize` needs to one of the following: ['true', 'pred', 'all', 'none', None] but got {normalize}"
    )


def _binary_confusion_matrix_update(preds: Tensor, target: Tensor, threshold: float,
                                    ignore_index: Optional[int]) -> Tensor:
    """int32 ``(2, 2)`` counts of one batch."""
    p, t, valid = _binary_format(preds, target, threshold, ignore_index)
    return _pair_counts(t, p, valid > 0, 2)


def binary_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _confusion_matrix_validate_args(normalize, ignore_index, threshold=threshold)
    confmat = _binary_confusion_matrix_update(*_as_tensors(preds, target), threshold, ignore_index)
    return _normalize_confmat(confmat, normalize)


def _kernel_inputs(preds: Any, target: Any, device: torch.device) -> tuple:
    """The multiclass inputs as the kernel takes them: float64 scores narrowed to
    float32 (the JAX package's x64-off types), other integer types to int32."""
    preds, target = torch.as_tensor(preds, device=device), torch.as_tensor(target, device=device)
    if preds.dtype == torch.float64:
        preds = preds.to(torch.float32)
    elif not preds.is_floating_point() and preds.dtype not in _KERNEL_INT_TYPES:
        preds = preds.to(torch.int32)
    if target.dtype not in _KERNEL_INT_TYPES:
        target = target.to(torch.int32)
    return preds.contiguous(), target.contiguous()


def _multiclass_confmat_accumulate(
    state: Tensor, preds: Any, target: Any, ignore_index: Optional[int]
) -> Tensor:
    """``state`` (int32 ``(C, C)``) plus one batch's counts, in place: the CUDA
    kernel for a state on the card, its plain version on the CPU."""
    preds, target = _kernel_inputs(preds, target, state.device)
    if state.device.type == "cpu":
        return _confmat_multiclass_plain(state, preds, target, ignore_index)
    return confmat_multiclass(state, preds, target, ignore_index)


def _multiclass_confusion_matrix_update(preds: Any, target: Any, num_classes: int,
                                        ignore_index: Optional[int]) -> Tensor:
    """int32 ``(C, C)`` counts of one batch."""
    state = torch.zeros((num_classes, num_classes), dtype=torch.int32, device=input_device(preds))
    return _multiclass_confmat_accumulate(state, preds, target, ignore_index)


def multiclass_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _confusion_matrix_validate_args(normalize, ignore_index, num_classes=num_classes)
    confmat = _multiclass_confusion_matrix_update(preds, target, num_classes, ignore_index)
    return _normalize_confmat(confmat, normalize)


def _multilabel_confusion_matrix_update(preds: Tensor, target: Tensor, threshold: float,
                                        ignore_index: Optional[int]) -> Tensor:
    """float32 ``(L, 2, 2)`` counts of one batch, ``[[tn, fp], [fn, tp]]`` a label."""
    p, t, v = _multilabel_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(p, t, v)
    return torch.stack([torch.stack([tn, fp], -1), torch.stack([fn, tp], -1)], -2)


def multilabel_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _confusion_matrix_validate_args(normalize, ignore_index, threshold=threshold, num_labels=num_labels)
    confmat = _multilabel_confusion_matrix_update(*_as_tensors(preds, target), threshold, ignore_index)
    return _normalize_confmat(confmat, normalize)


def confusion_matrix(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    task = str(task)
    if task == "binary":
        return binary_confusion_matrix(preds, target, threshold, normalize, ignore_index, validate_args)
    if task == "multiclass":
        _check_count("num_classes", num_classes)
        return multiclass_confusion_matrix(preds, target, num_classes, normalize, ignore_index, validate_args)
    if task == "multilabel":
        _check_count("num_labels", num_labels)
        return multilabel_confusion_matrix(preds, target, num_labels, threshold, normalize, ignore_index,
                                           validate_args)
    raise ValueError(f"Unsupported task `{task}` passed to `confusion_matrix`.")
