"""Matthews correlation coefficient (counterpart of ``torchmetrics_tpu/functional/classification/matthews_corrcoef.py``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.matthews_corrcoef import binary_matthews_corrcoef
    >>> round(float(binary_matthews_corrcoef(torch.tensor([0.1, 0.9, 0.8, 0.3]), torch.tensor([0, 1, 1, 1]))), 4)
    0.5774
"""

from __future__ import annotations

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    multiclass_confusion_matrix,
    multilabel_confusion_matrix,
)


def _matthews_corrcoef_reduce(confmat: Tensor) -> Tensor:
    """The generalized R_k statistic of a (C, C) confusion matrix; (L, 2, 2) is summed into one 2x2."""
    confmat = confmat.to(torch.float32)
    if confmat.ndim == 3:
        confmat = confmat.sum(0)
    tk, pk = confmat.sum(1), confmat.sum(0)  # true and predicted counts
    c, s = torch.trace(confmat), confmat.sum()
    cov_ytyp = c * s - torch.dot(tk, pk)
    cov_ypyp = s**2 - torch.dot(pk, pk)
    cov_ytyt = s**2 - torch.dot(tk, tk)
    denom = torch.sqrt(cov_ypyp * cov_ytyt)
    # one class in the preds or the target: 0, as sklearn gives
    zero = denom == 0
    return torch.where(zero, 0.0, cov_ytyp / torch.where(zero, 1.0, denom))


def binary_matthews_corrcoef(preds, target, threshold=0.5, ignore_index=None, validate_args=True):
    return _matthews_corrcoef_reduce(binary_confusion_matrix(preds, target, threshold, None, ignore_index,
                                                             validate_args))


def multiclass_matthews_corrcoef(preds, target, num_classes, ignore_index=None, validate_args=True):
    return _matthews_corrcoef_reduce(multiclass_confusion_matrix(preds, target, num_classes, None, ignore_index,
                                                                 validate_args))


def multilabel_matthews_corrcoef(preds, target, num_labels, threshold=0.5, ignore_index=None, validate_args=True):
    return _matthews_corrcoef_reduce(multilabel_confusion_matrix(preds, target, num_labels, threshold, None,
                                                                 ignore_index, validate_args))


def matthews_corrcoef(preds, target, task, threshold=0.5, num_classes=None, num_labels=None, ignore_index=None,
                      validate_args=True):
    task = str(task)
    if task == "binary":
        return binary_matthews_corrcoef(preds, target, threshold, ignore_index, validate_args)
    if task == "multiclass":
        return multiclass_matthews_corrcoef(preds, target, num_classes, ignore_index, validate_args)
    if task == "multilabel":
        return multilabel_matthews_corrcoef(preds, target, num_labels, threshold, ignore_index, validate_args)
    raise ValueError(f"Unsupported task `{task}` passed to `matthews_corrcoef`.")
