"""Correlation: Pearson, Spearman, Kendall, concordance (counterpart of
``torchmetrics_tpu/functional/regression/correlation.py``).

Pearson keeps Welford-style mergeable moments (mean_x, mean_y, var_x,
var_y, corr_xy, n); :func:`_final_aggregation` is the pairwise combine that
the metric's merge and its cross-rank sync both use. Kendall compares every
pair of rows, ``O(n^2)`` memory and work, as in the JAX package.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.regression.correlation import pearson_corrcoef, spearman_corrcoef
    >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
    >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
    >>> round(float(pearson_corrcoef(preds, target)), 4)
    0.9849
    >>> round(float(spearman_corrcoef(preds, target)), 4)
    1.0
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.basic import _pair


def _pearson_update(
    preds: Tensor,
    target: Tensor,
    mean_x: Tensor,
    mean_y: Tensor,
    var_x: Tensor,
    var_y: Tensor,
    corr_xy: Tensor,
    num_prior: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Welford-style streaming update of the correlation moments."""
    preds, target = _pair(preds, target, flatten=False)
    if preds.ndim == 1:
        preds, target = preds[:, None], target[:, None]
    n = preds.shape[0]
    num_obs = num_prior + n
    mx_new = (num_prior * mean_x + n * preds.mean(dim=0)) / num_obs
    my_new = (num_prior * mean_y + n * target.mean(dim=0)) / num_obs
    var_x = var_x + ((preds - mx_new) * (preds - mean_x)).sum(dim=0)
    var_y = var_y + ((target - my_new) * (target - mean_y)).sum(dim=0)
    corr_xy = corr_xy + ((preds - mx_new) * (target - mean_y)).sum(dim=0)
    return mx_new, my_new, var_x, var_y, corr_xy, num_obs


def _final_aggregation(
    means_x: Tensor, means_y: Tensor, vars_x: Tensor, vars_y: Tensor, corrs_xy: Tensor, nbs: Tensor
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Combine moment blocks stacked along dim 0 (ranks or states), pairwise in order."""
    if means_x.ndim == 1:
        return means_x, means_y, vars_x, vars_y, corrs_xy, nbs
    mx, my, vx, vy, cxy, n = means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0]
    for i in range(1, means_x.shape[0]):
        mx2, my2, vx2, vy2, cxy2, n2 = means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i]
        nt = n + n2
        safe_nt = torch.clamp(nt, min=1.0)
        mean_x = (n * mx + n2 * mx2) / safe_nt
        mean_y = (n * my + n2 * my2) / safe_nt
        vx = vx + vx2 + n * (mx - mean_x) ** 2 + n2 * (mx2 - mean_x) ** 2
        vy = vy + vy2 + n * (my - mean_y) ** 2 + n2 * (my2 - mean_y) ** 2
        cxy = cxy + cxy2 + n * (mx - mean_x) * (my - mean_y) + n2 * (mx2 - mean_x) * (my2 - mean_y)
        mx, my, n = mean_x, mean_y, nt
    return mx, my, vx, vy, cxy, n


def _pearson_compute(var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor) -> Tensor:
    denom = torch.sqrt(var_x) * torch.sqrt(var_y)
    zero = denom == 0
    corr = torch.where(zero, 0.0, corr_xy / torch.where(zero, 1.0, denom))
    return torch.clamp(corr, -1.0, 1.0).squeeze()


def pearson_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    preds, target = _pair(preds, target, flatten=False)
    z = torch.zeros(1 if preds.ndim == 1 else preds.shape[-1], device=preds.device)
    _, _, vx, vy, cxy, n = _pearson_update(preds, target, z, z, z, z, z, torch.zeros((), device=preds.device))
    return _pearson_compute(vx, vy, cxy, n)


def _rank_data_average(x: Tensor) -> Tensor:
    """1-based ranks, ties given their group's average rank (``scipy.stats.rankdata``)."""
    n = x.shape[0]
    order = torch.argsort(x, stable=True)
    xs = x[order]
    ordinal = torch.arange(1, n + 1, dtype=torch.float32, device=x.device)
    same_as_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=x.device), xs[1:] == xs[:-1]])
    group_start = torch.cummax(torch.where(same_as_prev, 0.0, ordinal), dim=0).values
    same_as_next = torch.cat([xs[:-1] == xs[1:], torch.zeros(1, dtype=torch.bool, device=x.device)])
    group_end = torch.where(same_as_next, float("inf"), ordinal)
    group_end = torch.flip(torch.cummin(torch.flip(group_end, (0,)), dim=0).values, (0,))
    ranks = torch.empty(n, dtype=torch.float32, device=x.device)
    ranks[order] = (group_start + group_end) / 2.0
    return ranks


def spearman_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Pearson on average-tie ranks."""
    preds, target = _pair(preds, target, flatten=False)
    if preds.ndim == 1:
        return pearson_corrcoef(_rank_data_average(preds), _rank_data_average(target))
    return torch.stack([pearson_corrcoef(_rank_data_average(preds[:, i]), _rank_data_average(target[:, i]))
                        for i in range(preds.shape[1])])


def kendall_rank_corrcoef(
    preds: Tensor, target: Tensor, variant: str = "b", t_test: bool = False, alternative: str = "two-sided"
) -> Tensor:
    """Kendall's tau (a, b or c) from the signs of every pair of rows."""
    preds, target = _pair(preds, target)
    n = preds.shape[0]
    sx = torch.sign(preds[:, None] - preds[None, :])
    sy = torch.sign(target[:, None] - target[None, :])
    upper = torch.ones((n, n), dtype=torch.bool, device=preds.device).triu_(1)  # each pair once
    sign_prod = sx * sy
    concordant = ((sign_prod > 0) & upper).sum()
    discordant = ((sign_prod < 0) & upper).sum()
    n_pairs = n * (n - 1) / 2.0
    if variant == "a":
        return (concordant - discordant) / n_pairs
    tie_x, tie_y = (sx == 0) & upper, (sy == 0) & upper
    if variant == "b":
        ties_both = (tie_x & tie_y).sum()
        tx = (tie_x & ~tie_y).sum() + ties_both
        ty = (tie_y & ~tie_x).sum() + ties_both
        denom = torch.sqrt((n_pairs - tx) * (n_pairs - ty))
        return (concordant - discordant) / torch.clamp(denom, min=1e-12)
    if variant == "c":
        n_distinct_x = (torch.diff(torch.sort(preds).values) != 0).sum() + 1
        n_distinct_y = (torch.diff(torch.sort(target).values) != 0).sum() + 1
        m = torch.minimum(n_distinct_x, n_distinct_y).to(torch.float32)
        return 2 * (concordant - discordant) / (n**2 * (m - 1) / m)
    raise ValueError(f"Argument `variant` is expected to be one of ('a', 'b', 'c'), got {variant}")


def concordance_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Lin's concordance correlation, with the n - 1 normalization (clamped at n = 1, as in the JAX package)."""
    preds, target = _pair(preds, target, flatten=False)
    if preds.ndim == 1:
        preds, target = preds[:, None], target[:, None]
    n = preds.shape[0]
    mx, my = preds.mean(dim=0), target.mean(dim=0)
    denom = max(n - 1, 1)
    vx = ((preds - mx) ** 2).sum(dim=0) / denom
    vy = ((target - my) ** 2).sum(dim=0) / denom
    cxy = ((preds - mx) * (target - my)).sum(dim=0) / denom
    return (2 * cxy / (vx + vy + (mx - my) ** 2)).squeeze()
