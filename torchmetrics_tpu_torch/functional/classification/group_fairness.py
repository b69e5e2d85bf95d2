"""Group fairness (counterpart of ``torchmetrics_tpu/functional/classification/group_fairness.py``).

Per-group tp/fp/tn/fn are float32 scatter-adds with the JAX package's index
rule: a group id in ``[-num_groups, 0)`` wraps once to ``id + num_groups``
and any id still out of range is dropped (``torch.index_add_`` would raise
on both). With 3 groups, ids ``[-1, 0, 2, 5]`` count -1 in group 2 and drop
5. Plain PyTorch on any device.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.group_fairness import binary_fairness
    >>> preds = torch.tensor([0.9, 0.2, 0.8, 0.4])
    >>> target = torch.tensor([1, 0, 1, 0])
    >>> groups = torch.tensor([0, 0, 1, 1])
    >>> {k: round(float(v), 4) for k, v in binary_fairness(preds, target, groups, num_groups=2).items()}
    {'DP_0_0': 1.0, 'EO_0_0': 1.0}
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import _binary_format
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import input_device, to_tensor

_FAIRNESS_TASKS = ("demographic_parity", "equal_opportunity", "all")


def _group_slots(groups: Tensor, num_groups: int) -> Tensor:
    """int64 slots of JAX's ``.at[g].add``: wrap a negative id once, send what is
    still out of range to the spare slot ``num_groups``."""
    g = groups.reshape(-1).to(torch.int32).to(torch.int64)
    g = torch.where(g < 0, g + num_groups, g)
    return torch.where((g >= 0) & (g < num_groups), g, num_groups)


def _groups_stat_scores(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-group float32 ``(tp, fp, tn, fn)``, each ``(num_groups,)``."""
    p, t, v = _binary_format(preds, target, threshold, ignore_index)
    p, t, v = p.reshape(-1).to(torch.float32), t.reshape(-1).to(torch.float32), v.reshape(-1)
    slots = _group_slots(groups, num_groups)
    zeros = torch.zeros(num_groups + 1, dtype=torch.float32, device=p.device)

    def scatter(values: Tensor) -> Tensor:
        return zeros.index_add(0, slots, values)[:num_groups]

    return scatter(p * t * v), scatter(p * (1 - t) * v), scatter((1 - p) * (1 - t) * v), scatter((1 - p) * t * v)


def _group_rates(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Dict[str, Tensor]:
    total = torch.clamp_min(tp + fp + tn + fn, 1.0)
    rates = torch.stack([tp, fp, tn, fn], dim=1) / total[:, None]
    return {f"group_{g}": rates[g] for g in range(tp.shape[0])}


def _fairness_results(task: str, tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Dict[str, Tensor]:
    """Demographic parity and equal opportunity: the min/max ratio of a rate over the groups,
    keyed by the argmin and argmax group ids (one host read for the keys)."""
    results: Dict[str, Tensor] = {}
    if task in ("demographic_parity", "all"):
        pos_rate = _safe_divide(tp + fp, tp + fp + tn + fn)
        lo, hi = (int(i) for i in torch.stack([pos_rate.argmin(), pos_rate.argmax()]).tolist())
        results[f"DP_{lo}_{hi}"] = _safe_divide(pos_rate[lo], pos_rate[hi])
    if task in ("equal_opportunity", "all"):
        tpr = _safe_divide(tp, tp + fn)
        lo, hi = (int(i) for i in torch.stack([tpr.argmin(), tpr.argmax()]).tolist())
        results[f"EO_{lo}_{hi}"] = _safe_divide(tpr[lo], tpr[hi])
    return results


def _validate_fairness_task(task: str) -> None:
    if task not in _FAIRNESS_TASKS:
        raise ValueError(
            f"Expected argument `task` to either be 'demographic_parity', 'equal_opportunity' or 'all' but got {task}."
        )


def _as_group_tensors(preds, target, groups) -> Tuple[Tensor, Tensor, Tensor]:
    device = input_device(preds)
    return to_tensor(preds, device), to_tensor(target, device), to_tensor(groups, device)


def binary_groups_stat_rates(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Per-group tp/fp/tn/fn rates: ``{"group_g": (4,)}``."""
    preds, target, groups = _as_group_tensors(preds, target, groups)
    return _group_rates(*_groups_stat_scores(preds, target, groups, num_groups, threshold, ignore_index))


def binary_fairness(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    task: str = "all",
    num_groups: Optional[int] = None,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Demographic parity and equal opportunity ratios; keys carry the argmin and argmax group ids."""
    _validate_fairness_task(task)
    preds, target, groups = _as_group_tensors(preds, target, groups)
    if num_groups is None:
        num_groups = int(groups.max()) + 1
    if task == "demographic_parity":
        target = torch.zeros_like(target)  # DP ignores the target
    return _fairness_results(task, *_groups_stat_scores(preds, target, groups, num_groups, threshold, ignore_index))
