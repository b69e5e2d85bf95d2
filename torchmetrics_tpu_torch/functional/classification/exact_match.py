"""Exact match (counterpart of ``torchmetrics_tpu/functional/classification/exact_match.py``).

A sample matches when every position (multiclass, multi-dim) or every label
(multilabel) of it is predicted right; ignored positions always match.
Plain PyTorch on any device over the stat-scores tower's indicators.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.exact_match import multilabel_exact_match
    >>> preds = torch.tensor([[0.9, 0.1, 0.8], [0.2, 0.7, 0.1]])
    >>> target = torch.tensor([[1, 0, 1], [0, 0, 0]])
    >>> round(float(multilabel_exact_match(preds, target, num_labels=3)), 4)
    0.5
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _as_tensors,
    _multiclass_indicators,
    _multiclass_validate_args,
    _multilabel_format,
    _multilabel_validate_args,
)
from torchmetrics_tpu_torch.utilities.compute import _safe_divide


def _multiclass_exact_match_stats(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """float32 ``(samplewise match, sample valid)`` ``(N,)``: the sufficient statistics of
    both averaging modes and of the modular class."""
    pred_ind, targ_ind, valid = _multiclass_indicators(preds, target, num_classes, 1, ignore_index)
    correct = (pred_ind * targ_ind).sum(1)  # (N, S)
    v = valid[:, 0, :]
    sample_match = torch.logical_or(correct > 0, v == 0).all(1).to(torch.float32)
    # samples that are entirely ignored don't count
    sample_valid = (v > 0).any(1).to(torch.float32)
    return sample_match * sample_valid, sample_valid


def multiclass_exact_match(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Fraction of samples where EVERY (multidim) position is predicted correctly."""
    if validate_args:
        _multiclass_validate_args(num_classes, 1, None, multidim_average, ignore_index)
    samplewise, sample_valid = _multiclass_exact_match_stats(*_as_tensors(preds, target), num_classes, ignore_index)
    if multidim_average == "global":
        return _safe_divide(samplewise.sum(), sample_valid.sum())
    return samplewise


def _multilabel_sample_match(preds: Tensor, target: Tensor, threshold: float, ignore_index: Optional[int]) -> Tensor:
    """float32 ``(N,)``: 1 where every label of the sample is right or ignored."""
    p, t, v = _multilabel_format(preds, target, threshold, ignore_index)
    n = p.shape[0]
    correct = torch.logical_or(p.reshape(n, -1) == t.reshape(n, -1), v.reshape(n, -1) == 0)
    return correct.all(1).to(torch.float32)


def multilabel_exact_match(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Fraction of samples where every label is predicted correctly."""
    if validate_args:
        _multilabel_validate_args(num_labels, threshold, None, multidim_average, ignore_index)
    sample_match = _multilabel_sample_match(*_as_tensors(preds, target), threshold, ignore_index)
    if multidim_average == "global":
        return sample_match.mean()
    return sample_match


def exact_match(
    preds: Tensor,
    target: Tensor,
    task: str,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    task = str(task)
    if task == "multiclass":
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.`")
        return multiclass_exact_match(preds, target, num_classes, multidim_average, ignore_index, validate_args)
    if task == "multilabel":
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.`")
        return multilabel_exact_match(preds, target, num_labels, threshold, multidim_average, ignore_index,
                                      validate_args)
    raise ValueError(f"Unsupported task `{task}` passed to `exact_match` (binary is not supported).")
