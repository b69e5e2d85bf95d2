"""Jaccard index, IoU (counterpart of ``torchmetrics_tpu/functional/classification/jaccard.py``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.jaccard import multiclass_jaccard_index
    >>> round(float(multiclass_jaccard_index(torch.tensor([2, 1, 0, 0]), torch.tensor([2, 1, 0, 1]), num_classes=3)), 4)
    0.6667
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    multiclass_confusion_matrix,
    multilabel_confusion_matrix,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide


def _ignore_mask(n: int, ignore_index: Optional[int], like: Tensor) -> Tensor:
    """Ones with a 0 at ``ignore_index`` as JAX's ``.at[ignore_index].set(0.0)`` places it:
    an index in ``[-n, 0)`` wraps, one outside ``[-n, n)`` masks nothing (255 at 19 classes)."""
    mask = torch.ones_like(like)
    if ignore_index is not None and -n <= ignore_index < n:
        mask[ignore_index] = 0.0
    return mask


def _jaccard_reduce(confmat: Tensor, average: Optional[str], ignore_index: Optional[int] = None,
                    zero_division: float = 0.0) -> Tensor:
    """The Jaccard score of a confusion matrix: ``(C, C)``, binary ``(2, 2)`` or multilabel ``(L, 2, 2)``."""
    confmat = confmat.to(torch.float32)
    if confmat.ndim == 3:  # multilabel [[tn, fp], [fn, tp]] a label
        fp, fn, tp = confmat[:, 0, 1], confmat[:, 1, 0], confmat[:, 1, 1]
        num, denom = tp, tp + fp + fn
    elif confmat.shape[-1] == 2 and average == "binary":
        fp, fn, tp = confmat[0, 1], confmat[1, 0], confmat[1, 1]
        return _safe_divide(tp, tp + fp + fn, zero_division)
    else:
        num = torch.diagonal(confmat)
        denom = confmat.sum(0) + confmat.sum(1) - num
    ignore_mask = _ignore_mask(num.shape[0], ignore_index if confmat.ndim == 2 else None, num)
    if average == "micro":
        return _safe_divide((num * ignore_mask).sum(), (denom * ignore_mask).sum(), zero_division)
    scores = _safe_divide(num, denom, zero_division)
    if average in (None, "none"):
        return scores
    if average == "macro":
        present = (denom > 0).to(torch.float32) * ignore_mask
        return _safe_divide((scores * present).sum(), present.sum(), zero_division)
    if average == "weighted":
        weights = confmat[:, 1, :].sum(-1) if confmat.ndim == 3 else confmat.sum(1)
        weights = weights * ignore_mask
        return _safe_divide((scores * weights).sum(), weights.sum(), zero_division)
    raise ValueError(
        f"Argument `average` should be one of ['binary', 'micro', 'macro', 'weighted', 'none', None], got {average}"
    )


def binary_jaccard_index(preds, target, threshold=0.5, ignore_index=None, validate_args=True, zero_division=0.0):
    confmat = binary_confusion_matrix(preds, target, threshold, None, ignore_index, validate_args)
    return _jaccard_reduce(confmat, "binary", zero_division=zero_division)


def multiclass_jaccard_index(preds, target, num_classes, average="macro", ignore_index=None, validate_args=True,
                             zero_division=0.0):
    confmat = multiclass_confusion_matrix(preds, target, num_classes, None, ignore_index, validate_args)
    return _jaccard_reduce(confmat, average, ignore_index, zero_division)


def multilabel_jaccard_index(preds, target, num_labels, threshold=0.5, average="macro", ignore_index=None,
                             validate_args=True, zero_division=0.0):
    confmat = multilabel_confusion_matrix(preds, target, num_labels, threshold, None, ignore_index, validate_args)
    return _jaccard_reduce(confmat, average, zero_division=zero_division)


def jaccard_index(preds, target, task, threshold=0.5, num_classes=None, num_labels=None, average="macro",
                  ignore_index=None, validate_args=True, zero_division=0.0):
    task = str(task)
    if task == "binary":
        return binary_jaccard_index(preds, target, threshold, ignore_index, validate_args, zero_division)
    if task == "multiclass":
        return multiclass_jaccard_index(preds, target, num_classes, average, ignore_index, validate_args,
                                        zero_division)
    if task == "multilabel":
        return multilabel_jaccard_index(preds, target, num_labels, threshold, average, ignore_index, validate_args,
                                        zero_division)
    raise ValueError(f"Unsupported task `{task}` passed to `jaccard_index`.")
