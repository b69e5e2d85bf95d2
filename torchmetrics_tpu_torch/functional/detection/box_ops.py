"""Box primitives (counterpart of ``torchmetrics_tpu/functional/detection/box_ops.py``).

``box_convert``, ``box_area`` and the pairwise ``box_iou``,
``generalized_box_iou``, ``distance_box_iou`` and ``complete_box_iou`` as
batched tensor expressions, float32 as in the JAX package.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.detection.box_ops import box_iou
    >>> box_iou(torch.tensor([[0.0, 0.0, 2.0, 2.0]]), torch.tensor([[1.0, 0.0, 3.0, 2.0]]))
    tensor([[0.3333]])
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import Tensor


def box_convert(boxes: Tensor, in_fmt: str, out_fmt: str) -> Tensor:
    """Convert between xyxy / xywh / cxcywh box layouts."""
    if in_fmt == out_fmt:
        return boxes
    if in_fmt == "xywh":
        x, y, w, h = boxes.unbind(-1)
        boxes = torch.stack([x, y, x + w, y + h], dim=-1)
    elif in_fmt == "cxcywh":
        cx, cy, w, h = boxes.unbind(-1)
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    elif in_fmt != "xyxy":
        raise ValueError(f"Unsupported box format {in_fmt}")
    if out_fmt == "xyxy":
        return boxes
    x1, y1, x2, y2 = boxes.unbind(-1)
    if out_fmt == "xywh":
        return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)
    if out_fmt == "cxcywh":
        return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)
    raise ValueError(f"Unsupported box format {out_fmt}")


def box_area(boxes: Tensor) -> Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _pairwise_intersection_union(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    lt = torch.maximum(preds[:, None, :2], target[None, :, :2])
    rb = torch.minimum(preds[:, None, 2:], target[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(preds)[:, None] + box_area(target)[None, :] - inter
    return inter, union


def box_iou(preds: Tensor, target: Tensor) -> Tensor:
    """Pairwise IoU ``(N, M)`` of xyxy boxes."""
    inter, union = _pairwise_intersection_union(preds, target)
    return inter / torch.clamp(union, min=1e-12)


def _hull(preds: Tensor, target: Tensor) -> Tensor:
    """Width and height ``(N, M, 2)`` of each pair's smallest enclosing box."""
    lt = torch.minimum(preds[:, None, :2], target[None, :, :2])
    rb = torch.maximum(preds[:, None, 2:], target[None, :, 2:])
    return torch.clamp(rb - lt, min=0.0)


def generalized_box_iou(preds: Tensor, target: Tensor) -> Tensor:
    """Pairwise GIoU: IoU less the share of the enclosing box that the union leaves empty."""
    inter, union = _pairwise_intersection_union(preds, target)
    iou = inter / torch.clamp(union, min=1e-12)
    wh = _hull(preds, target)
    hull = wh[..., 0] * wh[..., 1]
    return iou - (hull - union) / torch.clamp(hull, min=1e-12)


def distance_box_iou(preds: Tensor, target: Tensor) -> Tensor:
    """Pairwise DIoU: IoU less the squared centre distance over the enclosing box's squared diagonal."""
    inter, union = _pairwise_intersection_union(preds, target)
    iou = inter / torch.clamp(union, min=1e-12)
    return iou - _center_distance_term(preds, target)


def _center_distance_term(preds: Tensor, target: Tensor) -> Tensor:
    wh = _hull(preds, target)
    diag_sq = wh[..., 0] ** 2 + wh[..., 1] ** 2
    cp = (preds[:, :2] + preds[:, 2:]) / 2
    ct = (target[:, :2] + target[:, 2:]) / 2
    d_sq = ((cp[:, None, :] - ct[None, :, :]) ** 2).sum(-1)
    return d_sq / torch.clamp(diag_sq, min=1e-12)


def complete_box_iou(preds: Tensor, target: Tensor) -> Tensor:
    """Pairwise CIoU: DIoU less the aspect-ratio term ``alpha * v``."""
    inter, union = _pairwise_intersection_union(preds, target)
    iou = inter / torch.clamp(union, min=1e-12)
    diou = iou - _center_distance_term(preds, target)
    wp = preds[:, 2] - preds[:, 0]
    hp = preds[:, 3] - preds[:, 1]
    wt = target[:, 2] - target[:, 0]
    ht = target[:, 3] - target[:, 1]
    v = (4 / math.pi**2) * (
        torch.arctan(wt[None, :] / torch.clamp(ht[None, :], min=1e-12))
        - torch.arctan(wp[:, None] / torch.clamp(hp[:, None], min=1e-12))
    ) ** 2
    alpha = v / torch.clamp(1 - iou + v, min=1e-12)
    return diou - alpha * v
