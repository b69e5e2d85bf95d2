"""Group fairness metric classes (counterpart of ``torchmetrics_tpu/classification/group_fairness.py``).

The state is ``tp``, ``fp``, ``tn`` and ``fn``, float32 ``(num_groups,)``,
``sum``-reduced; group ids wrap once and are then dropped as in the JAX
package (``functional.classification.group_fairness``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import BinaryFairness
    >>> metric = BinaryFairness(num_groups=2, device="cpu")
    >>> metric.update(torch.tensor([0.9, 0.2, 0.8, 0.4]), torch.tensor([1, 0, 1, 0]), torch.tensor([0, 0, 1, 1]))
    >>> {k: round(float(v), 4) for k, v in sorted(metric.compute().items())}
    {'DP_0_0': 1.0, 'EO_0_0': 1.0}
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.group_fairness import (
    _fairness_results,
    _group_rates,
    _groups_stat_scores,
    _validate_fairness_task,
)

_STATS = ("tp", "fp", "tn", "fn")


class BinaryGroupStatRates(Metric):
    """Per-group tp/fp/tn/fn rates: ``{"group_g": (4,)}``."""

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(self, num_groups: int, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_groups, int) and num_groups > 1):
            raise ValueError(f"Expected argument `num_groups` to be an int larger than 1, but got {num_groups}")
        self.num_groups = num_groups
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        for name in _STATS:
            self.add_state(name, torch.zeros(num_groups, dtype=torch.float32), dist_reduce_fx="sum")

    def _update(self, state: State, preds: Tensor, target: Tensor, groups: Tensor) -> State:
        stats = _groups_stat_scores(self._tensor(preds), self._tensor(target), self._tensor(groups),
                                    self.num_groups, self.threshold, self.ignore_index)
        return {name: state[name] + value for name, value in zip(_STATS, stats)}

    def _compute(self, state: State) -> Dict[str, Tensor]:
        return _group_rates(*(state[name] for name in _STATS))


class BinaryFairness(BinaryGroupStatRates):
    """Demographic parity and equal opportunity over the accumulated groups."""

    def __init__(self, num_groups: int, task: str = "all", threshold: float = 0.5,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        _validate_fairness_task(task)
        super().__init__(num_groups, threshold, ignore_index, validate_args, **kwargs)
        self.task = task

    def _update(self, state: State, preds: Tensor, target: Tensor, groups: Tensor) -> State:
        if self.task == "demographic_parity":
            target = torch.zeros_like(self._tensor(target))
        return super()._update(state, preds, target, groups)

    def _compute(self, state: State) -> Dict[str, Tensor]:
        return _fairness_results(self.task, *(state[name] for name in _STATS))
