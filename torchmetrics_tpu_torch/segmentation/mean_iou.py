"""MeanIoU (counterpart of ``torchmetrics_tpu/segmentation/mean_iou.py``).

State: the float32 sum of per-sample scores (a class each with
``per_class``) and the float32 sample count, both sum-reduced. An update of
index maps on the card is one ``segmentation_counts`` launch; the maps are
read as given (uint8, int32 or int64), not narrowed first.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.segmentation import MeanIoU
    >>> metric = MeanIoU(num_classes=3, device="cpu")
    >>> metric.update(torch.tensor([[0, 1, 2, 1]]), torch.tensor([[0, 1, 2, 2]]))
    >>> round(float(metric.compute()), 4)
    0.75
"""

from __future__ import annotations

from typing import Any, Literal

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.segmentation.mean_iou import (
    _mean_iou_compute,
    _mean_iou_update,
    _segmentation_validate_args,
)


class MeanIoU(Metric):
    """Mean Intersection over Union for semantic segmentation."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_classes: int,
        include_background: bool = True,
        per_class: bool = False,
        input_format: Literal["one-hot", "index"] = "one-hot",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _segmentation_validate_args(num_classes, include_background, per_class, input_format)
        self.num_classes = num_classes
        self.include_background = include_background
        self.per_class = per_class
        self.input_format = input_format

        n_out = num_classes - 1 if not include_background else num_classes
        self.add_state("score", torch.zeros(n_out if per_class else 1), dist_reduce_fx="sum")
        self.add_state("num_samples", torch.zeros(()), dist_reduce_fx="sum")

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        preds, target = torch.as_tensor(preds, device=self.device), torch.as_tensor(target, device=self.device)
        intersection, union = _mean_iou_update(
            preds, target, self.num_classes, self.include_background, self.input_format
        )
        score = _mean_iou_compute(intersection, union, per_class=self.per_class)
        return {
            "score": state["score"] + (score.sum(0) if self.per_class else score.sum()),
            "num_samples": state["num_samples"] + preds.shape[0],
        }

    def _compute(self, state: State) -> Tensor:
        out = state["score"] / state["num_samples"].clamp_min(1.0)
        return out if self.per_class else out.squeeze()
