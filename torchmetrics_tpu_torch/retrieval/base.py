"""Retrieval metric base (counterpart of ``torchmetrics_tpu/retrieval/base.py``).

``update(preds, target, indexes)`` appends to three cat leaves (indexes,
preds, target); ``compute`` hands the concatenated rows to
:func:`~torchmetrics_tpu_torch.functional.retrieval.kernels.retrieval_scores`,
which gives every query's score at once (one ``retrieval_groups`` launch on
the card), then applies the empty-query policy and the aggregation.

The update checks its inputs on the device with at most one host read: the
binary check of the target and, with ``ignore_index``, the count of kept
rows are read together; the kept rows are taken in order by a stable sort of
the mask, so the filter itself waits for nothing more.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.retrieval import RetrievalMAP
    >>> metric = RetrievalMAP(device="cpu")
    >>> metric.update(torch.tensor([0.2, 0.3, 0.5, 0.1]), torch.tensor([0, 1, 0, 1]), torch.tensor([0, 0, 0, 1]))
    >>> round(float(metric.compute()), 4)
    0.75
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.retrieval.kernels import retrieval_scores
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

_AGG_OPTIONS = ("mean", "median", "min", "max")


def _retrieval_aggregate(values: Tensor, aggregation: Union[str, Callable] = "mean",
                         axis: Optional[int] = None) -> Tensor:
    """Aggregate per-query scores; ``median`` averages the two middle values, as ``jnp.median`` does."""
    if aggregation == "mean":
        return values.mean() if axis is None else values.mean(dim=axis)
    if aggregation == "median":
        return torch.quantile(values, 0.5) if axis is None else torch.quantile(values, 0.5, dim=axis)
    if aggregation == "min":
        return values.min() if axis is None else values.amin(dim=axis)
    if aggregation == "max":
        return values.max() if axis is None else values.amax(dim=axis)
    return aggregation(values, axis=axis)


class RetrievalMetric(Metric):
    """Base for metrics grouped by query index.

    ``empty_target_action`` controls queries with no positive target:
    ``'neg'`` gives 0, ``'pos'`` 1, ``'skip'`` drops them and ``'error'``
    raises. A subclass names its measure (a key of
    ``kernels.retrieval.MEASURES``) in ``_measure``.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    allow_non_binary_target = False
    _measure = ""

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 aggregation: Union[str, Callable] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if empty_target_action not in ("error", "skip", "neg", "pos"):
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index
        if not (aggregation in _AGG_OPTIONS or callable(aggregation)):
            raise ValueError(
                "Argument `aggregation` must be one of `mean`, `median`, `min`, `max` or a custom "
                f"callable function which takes tensor of values, but got {aggregation}."
            )
        self.aggregation = aggregation
        self.add_state("indexes", [], dist_reduce_fx="cat")
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def _check_inputs(self, preds: Any, target: Any, indexes: Any) -> Tuple[Tensor, Tensor, Tensor]:
        if indexes is None:
            raise ValueError("Argument `indexes` cannot be None")
        preds = self._tensor(preds).reshape(-1).to(torch.float32)
        target = self._tensor(target).reshape(-1)
        indexes = self._tensor(indexes).reshape(-1)
        if not (preds.shape == target.shape == indexes.shape):
            raise ValueError("`indexes`, `preds` and `target` must be of the same shape")
        checks = []
        keep = None
        if self.ignore_index is not None:
            keep = target != self.ignore_index
            checks.append(keep.sum())
        if not self.allow_non_binary_target:
            bad = (target != 0) & (target != 1)
            checks.append((bad if keep is None else bad & keep).any().to(torch.int64))
        if checks:
            read = torch.stack(checks).tolist()  # the update's one host read
            if not self.allow_non_binary_target and read[-1]:
                raise ValueError("`target` must contain binary values")
            if keep is not None and read[0] < keep.shape[0]:
                rows = torch.sort((~keep).to(torch.uint8), stable=True).indices[: read[0]]
                preds, target, indexes = preds[rows], target[rows], indexes[rows]
        return preds, target.to(torch.float32), indexes

    def _update(self, state: State, preds: Tensor, target: Tensor, indexes: Tensor) -> State:
        preds, target, indexes = self._check_inputs(preds, target, indexes)
        return {
            "indexes": state["indexes"] + (indexes,),
            "preds": state["preds"] + (preds,),
            "target": state["target"] + (target,),
        }

    def _measure_kwargs(self) -> Dict[str, Any]:
        return {"top_k": getattr(self, "top_k", None)}

    def _empty_mask(self, n_rel: Tensor, sizes: Tensor) -> Tensor:
        """True for queries hit by ``empty_target_action`` (no positive target)."""
        return n_rel == 0

    def _grouped(self, state: State) -> Tuple[Tensor, Tensor]:
        """Every query's score and whether the empty-target action applies to it."""
        preds, target, indexes = (dim_zero_cat(state[k]) for k in ("preds", "target", "indexes"))
        scores, n_rel, sizes = retrieval_scores(preds, target, indexes, self._measure, **self._measure_kwargs())
        return scores, self._empty_mask(n_rel, sizes)

    def _compute(self, state: State) -> Tensor:
        if not state["preds"]:
            return torch.zeros((), device=self.device)
        return self._aggregate_scores(*self._grouped(state))

    def _aggregate_scores(self, scores: Tensor, empty: Tensor) -> Tensor:
        if self.empty_target_action == "error" and bool(empty.any()):
            raise ValueError("`compute` method was provided with a query with no positive target.")
        if self.empty_target_action == "skip":
            scores = scores[~empty]
            if scores.numel() == 0:
                return torch.zeros((), device=scores.device)
        elif self.empty_target_action == "pos":
            scores = torch.where(empty, 1.0, scores)
        else:  # neg
            scores = torch.where(empty, 0.0, scores)
        return _retrieval_aggregate(scores, self.aggregation)
