"""Cohen's kappa (counterpart of ``torchmetrics_tpu/functional/classification/cohen_kappa.py``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.cohen_kappa import multiclass_cohen_kappa
    >>> round(float(multiclass_cohen_kappa(torch.tensor([2, 1, 0, 1]), torch.tensor([2, 1, 0, 0]), num_classes=3)), 4)
    0.6364
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    multiclass_confusion_matrix,
)


def _cohen_kappa_reduce(confmat: Tensor, weights: Optional[str] = None) -> Tensor:
    """kappa = (p_o - p_e) / (1 - p_e), with optional linear or quadratic weights."""
    confmat = confmat.to(torch.float32)
    n_classes = confmat.shape[-1]
    p = confmat / confmat.sum()
    expected = torch.outer(p.sum(1), p.sum(0))  # true marginals x predicted marginals
    if weights is None:
        w = 1.0 - torch.eye(n_classes, dtype=torch.float32, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        idx = torch.arange(n_classes, dtype=torch.float32, device=confmat.device)
        diff = (idx[:, None] - idx[None, :]).abs()
        w = diff if weights == "linear" else diff**2
    else:
        raise ValueError(
            f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'"
        )
    return 1.0 - (w * p).sum() / (w * expected).sum()


def binary_cohen_kappa(preds, target, threshold=0.5, weights=None, ignore_index=None, validate_args=True):
    confmat = binary_confusion_matrix(preds, target, threshold, None, ignore_index, validate_args)
    return _cohen_kappa_reduce(confmat, weights)


def multiclass_cohen_kappa(preds, target, num_classes, weights=None, ignore_index=None, validate_args=True):
    confmat = multiclass_confusion_matrix(preds, target, num_classes, None, ignore_index, validate_args)
    return _cohen_kappa_reduce(confmat, weights)


def cohen_kappa(preds, target, task, threshold=0.5, num_classes=None, weights=None, ignore_index=None,
                validate_args=True):
    task = str(task)
    if task == "binary":
        return binary_cohen_kappa(preds, target, threshold, weights, ignore_index, validate_args)
    if task == "multiclass":
        return multiclass_cohen_kappa(preds, target, num_classes, weights, ignore_index, validate_args)
    raise ValueError(f"Unsupported task `{task}` passed to `cohen_kappa` (multilabel is not supported).")
