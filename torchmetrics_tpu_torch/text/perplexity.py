"""Perplexity class (counterpart of ``torchmetrics_tpu/text/perplexity.py``).

Each update is one ``perplexity_nll`` launch on the card
(:func:`~torchmetrics_tpu_torch.functional.text.perplexity._perplexity_update`);
the state is two float32 sums, the negative log-likelihood and the token
count. The update is differentiable.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.text import Perplexity
    >>> metric = Perplexity(device="cpu")
    >>> logits = torch.log(torch.tensor([[[0.7, 0.2, 0.1], [0.1, 0.8, 0.1]]]))
    >>> metric.update(logits, torch.tensor([[0, 1]]))
    >>> round(float(metric.compute()), 4)
    1.3363
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.text.perplexity import _perplexity_compute, _perplexity_update


class Perplexity(Metric):
    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError(f"Argument `ignore_index` expected to either be `None` or an `int` but got {ignore_index}")
        self.ignore_index = ignore_index
        self.add_state("total_log_probs", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("count", torch.zeros(()), dist_reduce_fx="sum")

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        total, count = _perplexity_update(self._tensor(preds), self._tensor(target), self.ignore_index)
        return {"total_log_probs": state["total_log_probs"] + total, "count": state["count"] + count}

    def _compute(self, state: State) -> Tensor:
        return _perplexity_compute(state["total_log_probs"], state["count"])
