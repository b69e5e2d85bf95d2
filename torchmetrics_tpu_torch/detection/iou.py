"""The IoU-family metrics (counterpart of ``torchmetrics_tpu/detection/iou.py``).

The state is a list of per-image IoU matrices, each ``(D, G)`` float32 on
the metric's device, with the pairs of different labels (under
``respect_labels``) and, with ``iou_threshold``, those below it set to the
class's ``_invalid_val``; and a list of each image's ground-truth labels.
``compute`` takes the mean of the valid entries, and with
``class_metrics`` one mean a ground-truth class, on the host, as the JAX
package does.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.detection import IntersectionOverUnion
    >>> preds = [dict(boxes=torch.tensor([[258.0, 41.0, 606.0, 285.0]]),
    ...               scores=torch.tensor([0.536]), labels=torch.tensor([0]))]
    >>> target = [dict(boxes=torch.tensor([[214.0, 41.0, 562.0, 285.0]]), labels=torch.tensor([0]))]
    >>> metric = IntersectionOverUnion(device="cpu")
    >>> metric.update(preds, target)
    >>> round(float(metric.compute()['iou']), 4)
    0.7755
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.detection.box_ops import box_convert
from torchmetrics_tpu_torch.functional.detection.iou import _ciou_update, _diou_update, _giou_update, _iou_update


def _input_validator(preds: Sequence, target: Sequence, ignore_score: bool = False) -> None:
    if not isinstance(preds, Sequence) or not isinstance(target, Sequence):
        raise ValueError("Expected argument `preds` and `target` to be a sequence of dicts")
    if len(preds) != len(target):
        raise ValueError("Expected argument `preds` and `target` to have the same length")
    for p in preds:
        for k in ("boxes", "labels") if ignore_score else ("boxes", "scores", "labels"):
            if k not in p:
                raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")
    for t in target:
        for k in ("boxes", "labels"):
            if k not in t:
                raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")


class IntersectionOverUnion(Metric):
    """Mean IoU of the detection and ground-truth boxes of each image."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = True

    _iou_type: str = "iou"
    _invalid_val: float = -1.0
    _iou_update_fn: Callable = staticmethod(_iou_update)

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_threshold: Optional[float] = None,
        class_metrics: bool = False,
        respect_labels: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if box_format not in ("xyxy", "xywh", "cxcywh"):
            raise ValueError(f"Expected argument `box_format` to be one of ('xyxy', 'xywh', 'cxcywh') but got {box_format}")
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        if not isinstance(respect_labels, bool):
            raise ValueError("Expected argument `respect_labels` to be a boolean")
        self.box_format = box_format
        self.iou_threshold = iou_threshold
        self.class_metrics = class_metrics
        self.respect_labels = respect_labels
        self.add_state("groundtruth_labels", [], dist_reduce_fx=None)
        self.add_state("iou_matrix", [], dist_reduce_fx=None)

    def _update(self, state: State, preds: List[Dict[str, Any]], target: List[Dict[str, Any]]) -> State:
        _input_validator(preds, target, ignore_score=True)
        new = dict(state)
        for p, t in zip(preds, target):
            iou = type(self)._iou_update_fn(self._convert(p["boxes"]), self._convert(t["boxes"]), self.iou_threshold,
                                            self._invalid_val)
            t_labels = self._tensor(t["labels"]).reshape(-1)
            if self.respect_labels:
                p_labels = self._tensor(p["labels"]).reshape(-1)
                iou = torch.where(p_labels[:, None] == t_labels[None, :], iou,
                                  torch.full_like(iou, self._invalid_val))
            new["groundtruth_labels"] = new["groundtruth_labels"] + (t_labels,)
            new["iou_matrix"] = new["iou_matrix"] + (iou,)
        return new

    def _convert(self, boxes: Any) -> Tensor:
        boxes = self._tensor(boxes).to(torch.float32)
        boxes = boxes.reshape(-1, 4) if boxes.numel() else torch.zeros((0, 4), device=self.device)
        return box_convert(boxes, in_fmt=self.box_format, out_fmt="xyxy")

    def _compute(self, state: State) -> Dict[str, Tensor]:
        valid = [m[m != self._invalid_val] for m in state["iou_matrix"]]
        flat = torch.cat(valid) if valid else torch.zeros(0, device=self.device)
        results: Dict[str, Tensor] = {
            self._iou_type: flat.mean() if flat.numel() else torch.zeros((), device=self.device)}
        if self.class_metrics:
            # on the host, as the JAX package buckets its ragged matrices: a float64 sum of float32 entries a class
            mats = [m.cpu().numpy() for m in state["iou_matrix"]]
            labels = [g.cpu().numpy() for g in state["groundtruth_labels"]]
            classes = np.unique(np.concatenate(labels)).tolist() if labels and sum(g.size for g in labels) else []
            for cl in classes:
                total, cnt = 0.0, 0
                for mat, gl in zip(mats, labels):
                    scores = mat[:, gl == cl]
                    sel = scores[scores != self._invalid_val]
                    total += float(sel.sum())
                    cnt += int(sel.size)
                results[f"{self._iou_type}/cl_{int(cl)}"] = torch.tensor(total / cnt if cnt else 0.0,
                                                                         dtype=torch.float32, device=self.device)
        return results


class GeneralizedIntersectionOverUnion(IntersectionOverUnion):
    """Mean GIoU of the detection and ground-truth boxes of each image."""

    _iou_type = "giou"
    _invalid_val = -2.0
    _iou_update_fn = staticmethod(_giou_update)


class DistanceIntersectionOverUnion(IntersectionOverUnion):
    """Mean DIoU of the detection and ground-truth boxes of each image."""

    _iou_type = "diou"
    _invalid_val = -2.0
    _iou_update_fn = staticmethod(_diou_update)


class CompleteIntersectionOverUnion(IntersectionOverUnion):
    """Mean CIoU of the detection and ground-truth boxes of each image."""

    _iou_type = "ciou"
    _invalid_val = -2.0
    _iou_update_fn = staticmethod(_ciou_update)
