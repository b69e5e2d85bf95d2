"""Mean IoU for semantic segmentation (counterpart of ``torchmetrics_tpu/functional/segmentation/mean_iou.py``).

Index maps (``input_format="index"``) go to the ``segmentation_counts`` CUDA
kernel on the card (``kernels/segmentation.py``): each image's intersection,
prediction and target count a class in one pass, with no one-hot; on the CPU
its plain version, JAX's one-hot form. A label is taken as ``jnp.eye(C)[idx]``
takes it: a negative index wraps once, then it is clamped to ``[0, C-1]``, so
a void 255 counts as the last class. One-hot inputs keep JAX's bool casts and
sums as torch ops. Intersections and unions are int32, as JAX's sums of bools.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.segmentation.mean_iou import mean_iou
    >>> preds = torch.tensor([[0, 0, 1, 1]])
    >>> target = torch.tensor([[0, 1, 1, 1]])
    >>> [round(float(v), 4) for v in mean_iou(preds, target, num_classes=2, input_format='index')]
    [0.5833]
"""

from __future__ import annotations

from typing import Any, Literal, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels.segmentation import KINDS, _segmentation_counts_plain, segmentation_counts
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import input_device


def _segmentation_validate_args(
    num_classes: int,
    include_background: bool,
    per_class: bool,
    input_format: str,
) -> None:
    if num_classes <= 0:
        raise ValueError(f"Expected argument `num_classes` must be a positive integer, but got {num_classes}.")
    if not isinstance(include_background, bool):
        raise ValueError(f"Expected argument `include_background` must be a boolean, but got {include_background}.")
    if not isinstance(per_class, bool):
        raise ValueError(f"Expected argument `per_class` must be a boolean, but got {per_class}.")
    if input_format not in ("one-hot", "index"):
        raise ValueError(f"Expected argument `input_format` to be one of 'one-hot', 'index', but got {input_format}.")


def _as_tensors(preds: Any, target: Any) -> Tuple[Tensor, Tensor]:
    device = input_device(preds)
    return torch.as_tensor(preds, device=device), torch.as_tensor(target, device=device)


def _index_counts(preds: Tensor, target: Tensor, num_classes: int) -> Tensor:
    """``(N, 3, C)`` int32 intersection, prediction and target counts of index maps: the CUDA
    kernel for maps on the card, its plain version on the CPU. Integer types the kernel does not
    take are widened to int32 (the same labels)."""
    if preds.is_floating_point() or target.is_floating_point():
        raise ValueError(f"Expected integer label maps with `input_format='index'`, got {preds.dtype} and "
                         f"{target.dtype}")
    preds, target = (x if x.dtype in KINDS else x.to(torch.int32) for x in (preds, target))
    preds, target = preds.contiguous(), target.contiguous()
    if preds.device.type == "cpu":
        return _segmentation_counts_plain(preds, target, num_classes)
    return segmentation_counts(preds, target, num_classes)


def _spatial_sum(x: Tensor) -> Tensor:
    """The sum over the axes after ``(N, C)`` (``jnp.sum`` over none of them: ``x`` itself)."""
    return x.sum(tuple(range(2, x.ndim))) if x.ndim > 2 else x


def _onehot_counts(preds: Tensor, target: Tensor) -> Tensor:
    """``(N, 3, C)`` counts of one-hot inputs ``(N, C, *S)``: JAX's bool casts and spatial sums."""
    preds_b, target_b = preds.to(torch.bool), target.to(torch.bool)
    sums = [_spatial_sum(preds_b & target_b), _spatial_sum(preds_b), _spatial_sum(target_b)]
    return torch.stack(sums, 1).to(torch.int32)


def _segmentation_counts(
    preds: Tensor, target: Tensor, num_classes: int, include_background: bool, input_format: str
) -> Tensor:
    """``(N, 3, C')`` int32 counts, class 0 dropped unless ``include_background``."""
    if preds.shape != target.shape:
        raise ValueError(f"Expected same shapes, got {tuple(preds.shape)} and {tuple(target.shape)}")
    if input_format == "index":
        counts = _index_counts(preds, target, num_classes)
    else:
        counts = _onehot_counts(preds, target)
    return counts if include_background else counts[:, :, 1:]


def _mean_iou_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    include_background: bool = False,
    input_format: Literal["one-hot", "index"] = "one-hot",
) -> Tuple[Tensor, Tensor]:
    preds, target = _as_tensors(preds, target)
    counts = _segmentation_counts(preds, target, num_classes, include_background, input_format)
    intersection, pred_sum, target_sum = counts.unbind(1)
    return intersection, pred_sum + target_sum - intersection


def _mean_iou_compute(intersection: Tensor, union: Tensor, per_class: bool = False) -> Tensor:
    val = _safe_divide(intersection.to(torch.float32), union.to(torch.float32))
    return val if per_class else val.mean(1)


def mean_iou(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    include_background: bool = True,
    per_class: bool = False,
    input_format: Literal["one-hot", "index"] = "one-hot",
) -> Tensor:
    """Per-sample mean IoU; shape (N,) or (N, C) when ``per_class``."""
    _segmentation_validate_args(num_classes, include_background, per_class, input_format)
    intersection, union = _mean_iou_update(preds, target, num_classes, include_background, input_format)
    return _mean_iou_compute(intersection, union, per_class)
