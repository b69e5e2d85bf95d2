"""GeneralizedDiceScore (counterpart of ``torchmetrics_tpu/segmentation/generalized_dice.py``).

State: the float32 sum of per-sample scores (a class each with
``per_class``) and the float32 sample count, both sum-reduced. An update of
index maps on the card is one ``segmentation_counts`` launch.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.segmentation import GeneralizedDiceScore
    >>> metric = GeneralizedDiceScore(num_classes=3, input_format='index', device="cpu")
    >>> metric.update(torch.tensor([[[0, 1], [2, 1]]]), torch.tensor([[[0, 1], [2, 2]]]))
    >>> round(float(metric.compute()), 4)
    0.7826
"""

from __future__ import annotations

from typing import Any, Literal

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.segmentation.generalized_dice import (
    _generalized_dice_compute,
    _generalized_dice_update,
    _generalized_dice_validate_args,
)


class GeneralizedDiceScore(Metric):
    """Generalized Dice score for semantic segmentation."""

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
        weight_type: Literal["square", "simple", "linear"] = "square",
        input_format: Literal["one-hot", "index"] = "one-hot",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _generalized_dice_validate_args(num_classes, include_background, per_class, weight_type, input_format)
        self.num_classes = num_classes
        self.include_background = include_background
        self.per_class = per_class
        self.weight_type = weight_type
        self.input_format = input_format

        n_out = num_classes - 1 if not include_background else num_classes
        self.add_state("score", torch.zeros(n_out if per_class else 1), dist_reduce_fx="sum")
        self.add_state("samples", torch.zeros(()), dist_reduce_fx="sum")

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        preds, target = torch.as_tensor(preds, device=self.device), torch.as_tensor(target, device=self.device)
        numerator, denominator = _generalized_dice_update(
            preds, target, self.num_classes, self.include_background, self.weight_type, self.input_format
        )
        score = _generalized_dice_compute(numerator, denominator, self.per_class)
        return {
            "score": state["score"] + score.sum(0),
            "samples": state["samples"] + preds.shape[0],
        }

    def _compute(self, state: State) -> Tensor:
        out = state["score"] / state["samples"].clamp_min(1.0)
        return out if self.per_class else out.squeeze()
