"""Dice metric class (counterpart of ``torchmetrics_tpu/classification/dice.py``).

The legacy-style entry point: binary probabilities ``(N,)`` (with
``multiclass=True``), ``(N, C)`` probabilities or logits, integer labels,
multilabel masks and multi-dim variants all go through
:func:`~torchmetrics_tpu_torch.utilities.formatting.classify_inputs`, on the
device of the inputs, before the per-class int32 stat-score accumulation.
Its checks raise the JAX package's errors: ``Dice(num_classes=19)`` on
Cityscapes targets with void 255 raises "The highest `target` label must be
below the C dimension of `preds`." with or without ``ignore_index=255``.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import Dice
    >>> metric = Dice(average="micro", num_classes=3, device="cpu")
    >>> metric.update(torch.tensor([2, 0, 2, 1]), torch.tensor([1, 0, 2, 1]))
    >>> round(float(metric.compute()), 4)
    0.75
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.classification.stat_scores import MulticlassStatScores
from torchmetrics_tpu_torch.core.metric import State
from torchmetrics_tpu_torch.functional.classification.dice import _dice_reduce
from torchmetrics_tpu_torch.utilities.formatting import classify_inputs


class Dice(MulticlassStatScores):
    """Dice score ``2 tp / (2 tp + fp + fn)`` over flexible-format inputs."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, num_classes: int, average: Optional[str] = "micro",
                 ignore_index: Optional[int] = None, top_k: int = 1,
                 threshold: float = 0.5, multiclass: Optional[bool] = None,
                 **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, top_k=top_k, average=average,
                         ignore_index=ignore_index, **kwargs)
        self.threshold = threshold
        self.multiclass = multiclass

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        p, t, case = classify_inputs(
            self._tensor(preds), self._tensor(target), threshold=self.threshold,
            top_k=None if self.top_k == 1 else self.top_k,
            num_classes=self.num_classes, multiclass=self.multiclass,
            ignore_index=self.ignore_index,
        )
        if p.shape[1] != self.num_classes:
            raise ValueError(
                f"Inputs canonicalized to {p.shape[1]} classes but `num_classes={self.num_classes}` "
                f"(detected case: {case.value})"
            )
        # fold multi-dim positions into the sample axis: (N, C[, X]) -> (N*X, C)
        if p.ndim == 3:
            p = p.movedim(1, 2).reshape(-1, p.shape[1])
            t = t.movedim(1, 2).reshape(-1, t.shape[1])
        tp = ((p == 1) & (t == 1)).sum(0)
        fp = ((p == 1) & (t == 0)).sum(0)
        tn = ((p == 0) & (t == 0)).sum(0)
        fn = ((p == 0) & (t == 1)).sum(0)
        return self._update_stats(state, tp, fp, tn, fn)

    def _compute(self, state: State) -> Tensor:
        tp, fp, tn, fn = self._final_state(state)
        if self.ignore_index is not None:
            # ignore_index removes the CLASS from every reduction; its samples
            # still count for the other classes
            keep = torch.arange(self.num_classes, device=tp.device) != self.ignore_index
            tp, fp, fn = tp[..., keep], fp[..., keep], fn[..., keep]
        return _dice_reduce(tp, fp, fn, self.average)
