"""Generalized Dice score for semantic segmentation (counterpart of
``torchmetrics_tpu/functional/segmentation/generalized_dice.py``).

The three per-image counts come from the same place as Mean IoU's (the
``segmentation_counts`` kernel for index maps on the card), cast to float32:
JAX's float32 sums of 0/1 are exact below 2**24 pixels an image, the int32
counts above it too. One-hot inputs are multiplied as floats, as JAX does.
An infinite class weight (a class absent from an image's target) is replaced
by that class's largest finite weight over the batch.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.segmentation.generalized_dice import generalized_dice_score
    >>> preds = torch.tensor([[[0, 0], [1, 1]]])
    >>> target = torch.tensor([[[0, 1], [1, 1]]])
    >>> [round(float(v), 4) for v in generalized_dice_score(preds, target, num_classes=2, input_format='index')]
    [0.6875]
"""

from __future__ import annotations

from typing import Literal, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.segmentation.mean_iou import _as_tensors, _index_counts, _spatial_sum
from torchmetrics_tpu_torch.utilities.compute import _safe_divide


def _generalized_dice_validate_args(
    num_classes: int,
    include_background: bool,
    per_class: bool,
    weight_type: str,
    input_format: str,
) -> None:
    if num_classes <= 0:
        raise ValueError(f"Expected argument `num_classes` must be a positive integer, but got {num_classes}.")
    if not isinstance(include_background, bool):
        raise ValueError(f"Expected argument `include_background` must be a boolean, but got {include_background}.")
    if not isinstance(per_class, bool):
        raise ValueError(f"Expected argument `per_class` must be a boolean, but got {per_class}.")
    if weight_type not in ("square", "simple", "linear"):
        raise ValueError(
            f"Expected argument `weight_type` to be one of 'square', 'simple', 'linear', but got {weight_type}."
        )
    if input_format not in ("one-hot", "index"):
        raise ValueError(f"Expected argument `input_format` to be one of 'one-hot', 'index', but got {input_format}.")


def _float_counts(preds: Tensor, target: Tensor, num_classes: int, input_format: str) -> Tuple[Tensor, Tensor, Tensor]:
    """float32 ``(N, C)`` intersection, target and prediction sums."""
    if input_format == "index":
        return _index_counts(preds, target, num_classes).to(torch.float32)[:, [0, 2, 1]].unbind(1)
    preds_f, target_f = preds.to(torch.float32), target.to(torch.float32)
    return _spatial_sum(preds_f * target_f), _spatial_sum(target_f), _spatial_sum(preds_f)


def _generalized_dice_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    include_background: bool,
    weight_type: Literal["square", "simple", "linear"] = "square",
    input_format: Literal["one-hot", "index"] = "one-hot",
) -> Tuple[Tensor, Tensor]:
    preds, target = _as_tensors(preds, target)
    if preds.shape != target.shape:
        raise ValueError(f"Expected same shapes, got {tuple(preds.shape)} and {tuple(target.shape)}")
    if preds.ndim < 3:
        raise ValueError(f"Expected both `preds` and `target` to have at least 3 dimensions, but got {preds.ndim}.")
    intersection, target_sum, pred_sum = _float_counts(preds, target, num_classes, input_format)
    if not include_background:
        intersection, target_sum, pred_sum = intersection[:, 1:], target_sum[:, 1:], pred_sum[:, 1:]
    cardinality = target_sum + pred_sum

    if weight_type == "simple":
        weights = 1.0 / target_sum
    elif weight_type == "linear":
        weights = torch.ones_like(target_sum)
    else:  # square
        weights = 1.0 / (target_sum**2)

    # absent classes get inf weights; replace by the per-class max finite weight across the batch
    infs = torch.isinf(weights)
    finite = torch.where(infs, torch.zeros_like(weights), weights)
    w_max = finite.amax(0, keepdim=True)  # (1, C)
    weights = torch.where(infs, w_max.expand_as(weights), weights)

    numerator = 2.0 * intersection * weights
    denominator = cardinality * weights
    return numerator, denominator


def _generalized_dice_compute(numerator: Tensor, denominator: Tensor, per_class: bool = True) -> Tensor:
    if not per_class:
        numerator = numerator.sum(1)
        denominator = denominator.sum(1)
    return _safe_divide(numerator, denominator)


def generalized_dice_score(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    include_background: bool = True,
    per_class: bool = False,
    weight_type: Literal["square", "simple", "linear"] = "square",
    input_format: Literal["one-hot", "index"] = "one-hot",
) -> Tensor:
    """Per-sample generalized Dice; shape (N,) or (N, C) when ``per_class``."""
    _generalized_dice_validate_args(num_classes, include_background, per_class, weight_type, input_format)
    numerator, denominator = _generalized_dice_update(
        preds, target, num_classes, include_background, weight_type, input_format
    )
    return _generalized_dice_compute(numerator, denominator, per_class)
