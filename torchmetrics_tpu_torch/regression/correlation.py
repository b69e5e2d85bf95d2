"""Correlation metrics (counterpart of ``torchmetrics_tpu/regression/correlation.py``).

``PearsonCorrCoef`` keeps Welford moment states (``dist_reduce_fx=None``):
they do not combine leaf by leaf, so it overrides ``merge_states`` and
``sync_states`` with the pairwise ``_final_aggregation`` over the moments of
the two states or of every rank. Its sync is one gather of all six moment
leaves (flattened into one buffer) and one sum of the update counters.
``MetricCollection.sync_states`` (through ``parallel.coalesce.coalesced_metric_sync``)
calls the override. Spearman and Kendall gather the raw values (``cat``):
rank statistics are not sum-decomposable.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import _N, Metric, State
from torchmetrics_tpu_torch.core.reductions import all_reduce, gather_all_tensors
from torchmetrics_tpu_torch.functional.regression.correlation import (
    _final_aggregation,
    _pearson_compute,
    _pearson_update,
    kendall_rank_corrcoef,
    spearman_corrcoef,
)
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

_MOMENTS = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")


class PearsonCorrCoef(Metric):
    """Streaming Pearson correlation from mergeable moment states.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import PearsonCorrCoef
        >>> metric = PearsonCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(metric.compute()), 4)
        0.9849
    """

    is_differentiable = True
    higher_is_better = None
    full_state_update = True

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_outputs, int) and num_outputs > 0):
            raise ValueError(f"Expected argument `num_outputs` to be an int larger than 0, but got {num_outputs}")
        self.num_outputs = num_outputs
        for name in _MOMENTS[:-1]:
            self.add_state(name, torch.zeros(num_outputs), dist_reduce_fx=None)
        self.add_state("n_total", torch.zeros(()), dist_reduce_fx=None)

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        moments = _pearson_update(self._tensor(preds), self._tensor(target), *(state[k] for k in _MOMENTS))
        return dict(zip(_MOMENTS, moments))

    def _aggregate(self, stacked) -> State:
        return dict(zip(_MOMENTS, _final_aggregation(*stacked)))

    def merge_states(self, a: State, b: State) -> State:
        out = self._aggregate(torch.stack([a[k], b[k]]) for k in _MOMENTS)
        out[_N] = a[_N] + b[_N]
        return out

    def sync_states(self, state: State, compression: Any = None, weight: Any = None) -> State:
        """Every rank's moments, gathered in one buffer, combined pairwise in rank order.

        The moments do not combine leaf by leaf, so this sync has no bucket to
        compress and no collective to mask: as JAX's override, which takes
        neither, it raises ``TypeError`` when given a compression or a weight.
        ``coalesced_metric_sync`` calls it without the compression (the sync
        stays exact) and with the weight (it raises).
        """
        if compression is not None or weight is not None:
            raise TypeError(
                f"{type(self).__name__}.sync_states takes no compression or weight: its moments are gathered "
                "and combined pairwise, not reduced in a bucket"
            )
        flat = torch.cat([state[k].reshape(-1) for k in _MOMENTS])
        ranks = torch.stack(gather_all_tensors(flat))  # (world, 5 * outputs + 1)
        stacked, offset = [], 0
        for k in _MOMENTS:
            size = state[k].numel()
            stacked.append(ranks[:, offset : offset + size].reshape(-1, *state[k].shape))
            offset += size
        out = self._aggregate(stacked)
        out[_N] = all_reduce(state[_N], "sum")
        return out

    def _compute(self, state: State) -> Tensor:
        return _pearson_compute(state["var_x"], state["var_y"], state["corr_xy"], state["n_total"])


class ConcordanceCorrCoef(PearsonCorrCoef):
    """Lin's concordance correlation from the same moment states (n - 1 normalization)."""

    def _compute(self, state: State) -> Tensor:
        n = torch.clamp(state["n_total"] - 1.0, min=1.0)
        vx, vy, cxy = state["var_x"] / n, state["var_y"] / n, state["corr_xy"] / n
        return (2 * cxy / (vx + vy + (state["mean_x"] - state["mean_y"]) ** 2)).squeeze()


class _CatCorrBase(Metric):
    """Base of the correlations that need the whole sample (rank statistics)."""

    is_differentiable = False
    full_state_update = False

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.num_outputs = num_outputs
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        return {
            "preds": state["preds"] + (self._tensor(preds).to(torch.float32),),
            "target": state["target"] + (self._tensor(target).to(torch.float32),),
        }


class SpearmanCorrCoef(_CatCorrBase):
    """Spearman rank correlation over the whole accumulated sample.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import SpearmanCorrCoef
        >>> metric = SpearmanCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> round(float(metric.compute()), 4)
        1.0
    """

    higher_is_better = None

    def _compute(self, state: State) -> Tensor:
        return spearman_corrcoef(dim_zero_cat(state["preds"]), dim_zero_cat(state["target"]))


class KendallRankCorrCoef(_CatCorrBase):
    """Kendall's tau over the whole accumulated sample (every pair of rows: ``O(n^2)``)."""

    higher_is_better = None

    def __init__(self, variant: str = "b", t_test: bool = False,
                 alternative: str = "two-sided", num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(num_outputs=num_outputs, **kwargs)
        self.variant = variant
        self.t_test = t_test
        self.alternative = alternative

    def _compute(self, state: State) -> Tensor:
        return kendall_rank_corrcoef(dim_zero_cat(state["preds"]), dim_zero_cat(state["target"]), self.variant)
