"""IoU-family functionals (counterpart of ``torchmetrics_tpu/functional/detection/iou.py``).

Each takes xyxy boxes ``(N, 4)`` and ``(M, 4)`` and gives the pairwise
``(N, M)`` matrix, or with ``aggregate`` the mean of its diagonal (the
matched pairs). An ``iou_threshold`` replaces the values below it by
``replacement_val``. Float32, as in the JAX package.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.detection.iou import intersection_over_union
    >>> preds = torch.tensor([[100.0, 100.0, 200.0, 200.0]])
    >>> target = torch.tensor([[110.0, 110.0, 210.0, 210.0]])
    >>> round(float(intersection_over_union(preds, target, aggregate=True)), 4)
    0.6807
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.detection.box_ops import (
    box_iou,
    complete_box_iou,
    distance_box_iou,
    generalized_box_iou,
)
from torchmetrics_tpu_torch.utilities.data import input_device


def _boxes(x: Any, device: torch.device) -> Tensor:
    """``x`` as float32 ``(-1, 4)`` boxes; an empty input is ``(0, 4)``."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.reshape(-1, 4) if x.numel() else torch.zeros((0, 4), device=device)


def _make_update(pairwise_fn: Callable) -> Callable:
    def _update(preds: Any, target: Any, iou_threshold: Optional[float], replacement_val: float = 0) -> Tensor:
        device = input_device(preds)
        iou = pairwise_fn(_boxes(preds, device), _boxes(target, device))
        if iou_threshold is not None:
            iou = torch.where(iou < iou_threshold, torch.as_tensor(replacement_val, dtype=iou.dtype, device=device),
                              iou)
        return iou

    return _update


def _compute(iou: Tensor, aggregate: bool = True) -> Tensor:
    if not aggregate:
        return iou
    return iou.diagonal().mean() if iou.numel() else torch.zeros((), device=iou.device)


_iou_update = _make_update(box_iou)
_giou_update = _make_update(generalized_box_iou)
_diou_update = _make_update(distance_box_iou)
_ciou_update = _make_update(complete_box_iou)


def intersection_over_union(preds: Any, target: Any, iou_threshold: Optional[float] = None,
                            replacement_val: float = 0, aggregate: bool = True) -> Tensor:
    """Pairwise IoU, or the mean IoU of the matched (diagonal) pairs."""
    return _compute(_iou_update(preds, target, iou_threshold, replacement_val), aggregate)


def generalized_intersection_over_union(preds: Any, target: Any, iou_threshold: Optional[float] = None,
                                        replacement_val: float = 0, aggregate: bool = True) -> Tensor:
    """Pairwise GIoU, or the mean GIoU of the matched (diagonal) pairs."""
    return _compute(_giou_update(preds, target, iou_threshold, replacement_val), aggregate)


def distance_intersection_over_union(preds: Any, target: Any, iou_threshold: Optional[float] = None,
                                     replacement_val: float = 0, aggregate: bool = True) -> Tensor:
    """Pairwise DIoU, or the mean DIoU of the matched (diagonal) pairs."""
    return _compute(_diou_update(preds, target, iou_threshold, replacement_val), aggregate)


def complete_intersection_over_union(preds: Any, target: Any, iou_threshold: Optional[float] = None,
                                     replacement_val: float = 0, aggregate: bool = True) -> Tensor:
    """Pairwise CIoU, or the mean CIoU of the matched (diagonal) pairs."""
    return _compute(_ciou_update(preds, target, iou_threshold, replacement_val), aggregate)
