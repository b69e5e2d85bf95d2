"""Grouped retrieval ranking (counterpart of ``torchmetrics_tpu/functional/retrieval/kernels.py``).

Every query's score at once. On the CPU this is the JAX package's design
transliterated: one stable sort by ``(query, -score)`` (:func:`rank_groups`),
then segment sums over the queries (the ``grouped_*`` functions). On a CUDA
tensor the rows are put in order of query id by a stable ``torch.sort`` of
the ids, and one launch of the ``retrieval_groups`` kernel
(``csrc/retrieval.cu``) a measure orders each query's documents by score and
takes its sums, with no ``(n,)`` intermediates; :func:`rank_groups` there
takes the kernel's ranked layout. :func:`retrieval_scores` is the dispatch.

Indexes are int32 and targets float32, as in the JAX package (x64 off).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.retrieval.kernels import rank_groups, grouped_precision
    >>> from torchmetrics_tpu_torch.functional.retrieval.kernels import grouped_reciprocal_rank
    >>> preds = torch.tensor([0.9, 0.2, 0.7, 0.6])
    >>> target = torch.tensor([1, 0, 0, 1])
    >>> indexes = torch.tensor([0, 0, 1, 1])
    >>> rg = rank_groups(preds, target, indexes, num_groups=2)
    >>> [round(float(v), 4) for v in grouped_precision(rg, top_k=1)]
    [1.0, 0.0]
    >>> [round(float(v), 4) for v in grouped_reciprocal_rank(rg)]
    [1.0, 0.5]
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels.retrieval import retrieval_groups
from torchmetrics_tpu_torch.utilities.compute import _safe_divide
from torchmetrics_tpu_torch.utilities.data import input_device, to_tensor


class RankedGroups(NamedTuple):
    """All queries ranked at once: element tensors sorted by (group asc, pred desc)."""

    preds: Tensor  # (n,) sorted
    target: Tensor  # (n,) float32, same order
    gid: Tensor  # (n,) int32 contiguous group id
    rank: Tensor  # (n,) int32 0-based rank within its group
    wcum: Tensor  # (n,) within-group inclusive cumsum of target
    num_groups: int
    n_rel: Tensor  # (G,) relevant docs per group (the sum of the targets)
    sizes: Tensor  # (G,) docs per group


def _flat(preds, target, indexes) -> Tuple[Tensor, Tensor, Tensor]:
    device = input_device(preds)
    preds = to_tensor(preds, device).reshape(-1).to(torch.float32)
    target = to_tensor(target, device).reshape(-1).to(torch.float32)
    indexes = to_tensor(indexes, device).reshape(-1)
    return preds, target, indexes


def _empty_groups(device: torch.device) -> RankedGroups:
    z = torch.zeros((0,), dtype=torch.float32, device=device)
    zi = torch.zeros((0,), dtype=torch.int32, device=device)
    zero = torch.zeros((1,), dtype=torch.float32, device=device)
    return RankedGroups(z, z, zi, zi, z, 0, zero, zero)


def query_layout(preds: Tensor, target: Tensor, indexes: Tensor) -> Tuple[Tensor, Tensor, Tensor, int]:
    """The rows in order of query id, stable: ``(preds, target, offsets, longest)``.

    ``offsets`` (G + 1,) int64 bound each query's run of rows, ``longest`` is
    the most rows of a query. The outer key of the JAX package's ``lexsort``.
    Rows whose ids never decrease (updates of whole queries in order of id)
    are in order already and are not copied: two host reads, the runs of ids
    and then their order with the longest. The rest are sorted (a stable
    ``torch.sort`` of the ids): two host reads more, the sorted runs and the
    longest.
    """
    ids, counts = torch.unique_consecutive(indexes, return_counts=True)  # a host read
    in_order, longest = torch.stack([(ids[1:] > ids[:-1]).all(), counts.max()]).tolist()  # a host read
    if not in_order:
        order = torch.sort(indexes, stable=True).indices
        preds, target = preds[order], target[order]
        _, counts = torch.unique_consecutive(indexes[order], return_counts=True)  # a host read
        longest = int(counts.max())  # a host read
    offsets = torch.zeros((counts.shape[0] + 1,), dtype=torch.int64, device=preds.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return preds.contiguous(), target.contiguous(), offsets, longest


def rank_groups(preds: Tensor, target: Tensor, indexes: Tensor, num_groups: Optional[int] = None) -> RankedGroups:
    """Sort all queries' documents by relevance score and compute per-group ranks.

    Ties keep their order in the input, NaN scores go last in their query and
    ``-0.0`` ties ``+0.0``, as the JAX package's ``lexsort`` has them. On a
    CUDA tensor each query's order is the ``retrieval_groups`` kernel's
    ranked layout; on the CPU two stable sorts.
    """
    preds, target, indexes = _flat(preds, target, indexes)
    if preds.device.type == "cpu" or preds.shape[0] == 0:
        return _rank_groups_plain(preds, target, indexes, num_groups)
    p, t, offsets, longest = query_layout(preds, target, indexes)
    ranked, t = retrieval_groups(p, t, offsets, "ranked", longest=longest)
    return _ranked_groups(p[ranked.long()], t, None, num_groups, offsets)


def _rank_groups_plain(preds: Tensor, target: Tensor, indexes: Tensor,
                       num_groups: Optional[int] = None) -> RankedGroups:
    """Plain PyTorch ranked layout: the JAX ``lexsort`` as two stable sorts, on any device."""
    preds, target, indexes = _flat(preds, target, indexes)
    if preds.shape[0] == 0:
        return _empty_groups(preds.device)
    by_score = torch.sort(-preds, stable=True).indices
    order = by_score[torch.sort(indexes[by_score], stable=True).indices]
    g = indexes[order]
    new = torch.ones(g.shape, dtype=torch.bool, device=g.device)
    new[1:] = g[1:] != g[:-1]
    return _ranked_groups(preds[order], target[order], new, num_groups)


def _ranked_groups(p: Tensor, t: Tensor, new: Optional[Tensor], num_groups: Optional[int],
                   offsets: Optional[Tensor] = None) -> RankedGroups:
    """The ranks, within-group cumsum and group sums of a ranked layout whose groups start where ``new``,
    or at ``offsets`` (the query runs of ``query_layout``: each row's group and start by a gather, no scan)."""
    pos = torch.arange(p.shape[0], dtype=torch.int32, device=p.device)
    if offsets is None:
        gid = (torch.cumsum(new, 0) - 1).to(torch.int32)
        if num_groups is None:
            num_groups = int(gid[-1]) + 1
        start = torch.cummax(torch.where(new, pos, 0), 0).values
    else:
        groups = offsets.shape[0] - 1
        gid = torch.repeat_interleave(torch.arange(groups, dtype=torch.int32, device=p.device), torch.diff(offsets),
                                      output_size=p.shape[0])
        if num_groups is None:
            num_groups = groups
        start = offsets[:-1].to(torch.int32)[gid.long()]
    rank = pos - start
    c = torch.cumsum(t, 0)
    wcum = c - (c - t)[start.long()]
    n_rel = _seg_sum_by(t, gid, num_groups)
    sizes = _seg_sum_by(torch.ones_like(t), gid, num_groups)
    return RankedGroups(p, t, gid, rank, wcum, num_groups, n_rel, sizes)


def _seg_sum_by(values: Tensor, gid: Tensor, num_groups: int) -> Tensor:
    out = torch.zeros((max(num_groups, 1),), dtype=values.dtype, device=values.device)
    return out.index_add_(0, gid.long(), values)


def _topk_mask(rg: RankedGroups, top_k: Optional[int]) -> Tensor:
    """Boolean per-element mask: is this document within its query's top-k?"""
    if top_k is None:
        return torch.ones_like(rg.rank, dtype=torch.bool)
    return rg.rank < top_k


def _seg_sum(values: Tensor, rg: RankedGroups) -> Tensor:
    return _seg_sum_by(values.to(torch.float32), rg.gid, rg.num_groups)


def _k_eff(rg: RankedGroups, top_k: Optional[int], adaptive_k: bool) -> Tensor:
    """Per-group denominator k."""
    if top_k is None:
        return rg.sizes
    if adaptive_k:
        return torch.clamp(rg.sizes, max=float(top_k))
    return torch.full_like(rg.sizes, float(top_k))


# --------------------------------------------------------------- grouped measures (plain)
def grouped_precision(rg: RankedGroups, top_k: Optional[int] = None, adaptive_k: bool = False) -> Tensor:
    rel_topk = _seg_sum(rg.target * _topk_mask(rg, top_k), rg)
    return _safe_divide(rel_topk, _k_eff(rg, top_k, adaptive_k))


def grouped_recall(rg: RankedGroups, top_k: Optional[int] = None) -> Tensor:
    rel_topk = _seg_sum(rg.target * _topk_mask(rg, top_k), rg)
    return _safe_divide(rel_topk, rg.n_rel)


def grouped_hit_rate(rg: RankedGroups, top_k: Optional[int] = None) -> Tensor:
    rel_topk = _seg_sum(rg.target * _topk_mask(rg, top_k), rg)
    return (rel_topk > 0).to(torch.float32)


def grouped_fall_out(rg: RankedGroups, top_k: Optional[int] = None) -> Tensor:
    """Non-relevant in top-k / total non-relevant."""
    neg_topk = _seg_sum((1.0 - rg.target) * _topk_mask(rg, top_k), rg)
    return _safe_divide(neg_topk, rg.sizes - rg.n_rel)


def grouped_average_precision(rg: RankedGroups, top_k: Optional[int] = None) -> Tensor:
    """AP = mean over relevant docs in top-k of precision@their-rank."""
    mask = _topk_mask(rg, top_k)
    contrib = rg.target * mask * _safe_divide(rg.wcum, (rg.rank + 1).to(torch.float32))
    rel_topk = _seg_sum(rg.target * mask, rg)
    return _safe_divide(_seg_sum(contrib, rg), rel_topk)


def grouped_reciprocal_rank(rg: RankedGroups, top_k: Optional[int] = None) -> Tensor:
    n = rg.rank.shape[0]
    hit = (rg.target > 0) & _topk_mask(rg, top_k)
    first = torch.full((max(rg.num_groups, 1),), n, dtype=torch.int32, device=rg.rank.device)
    first = first.scatter_reduce(0, rg.gid.long(), torch.where(hit, rg.rank, n), "amin")
    return torch.where(first < n, 1.0 / (first + 1.0), 0.0)


def grouped_r_precision(rg: RankedGroups) -> Tensor:
    """Relevant within top-R where R = n_rel of the query."""
    kv = rg.n_rel[rg.gid.long()]
    rel_topr = _seg_sum(rg.target * (rg.rank < kv), rg)
    return _safe_divide(rel_topr, rg.n_rel)


def _dcg(rg: RankedGroups, top_k: Optional[int]) -> Tensor:
    disc = 1.0 / torch.log2(rg.rank.to(torch.float32) + 2.0)
    return _seg_sum(torch.clamp(rg.target, min=0.0) * disc * _topk_mask(rg, top_k), rg)


def grouped_ndcg(preds: Tensor, target: Tensor, indexes: Tensor, top_k: Optional[int] = None,
                 num_groups: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """NDCG per group and ``n_rel``; the ideal order is a second sort, by target (exact, ties not averaged)."""
    rg = rank_groups(preds, target, indexes, num_groups)
    ideal = rank_groups(target, target, indexes, num_groups)
    return _safe_divide(_dcg(rg, top_k), _dcg(ideal, top_k)), rg.n_rel


def _within_cumsum(values: Tensor, rg: RankedGroups) -> Tensor:
    """Within-group inclusive cumsum over the (group, -pred)-sorted layout."""
    c = torch.cumsum(values, 0)
    start = torch.arange(values.shape[0], dtype=torch.int32, device=values.device) - rg.rank
    return c - (c - values)[start.long()]


def grouped_auroc(rg: RankedGroups, top_k: Optional[int] = None) -> Tensor:
    """Per-group AUROC over the top-k subset by the pair-counting identity on the
    descending-sorted docs, with half credit for tied positive/negative pairs."""
    n = rg.rank.shape[0]
    if n == 0:
        return torch.zeros_like(rg.n_rel)
    pos = torch.arange(n, dtype=torch.int32, device=rg.rank.device)
    mask = _topk_mask(rg, top_k).to(torch.float32)
    posm = rg.target * mask
    negm = (1.0 - rg.target) * mask
    n_pos = _seg_sum(posm, rg)
    n_neg = _seg_sum(negm, rg)

    # tie runs: consecutive equal scores within a group share a run (NaN != NaN: each its own)
    new_run = rg.rank == 0
    new_run[1:] |= rg.preds[1:] != rg.preds[:-1]
    run_start = torch.cummax(torch.where(new_run, pos, 0), 0).values
    a = torch.where(new_run, pos, n)
    suf = torch.flip(torch.cummin(torch.flip(a, (0,)), 0).values, (0,))
    next_start = torch.cat([suf[1:], torch.full((1,), n, dtype=suf.dtype, device=suf.device)])
    run_end = next_start - 1

    wncum = _within_cumsum(negm, rg)
    neg_strict_above = (wncum - negm)[run_start.long()]
    neg_tied = wncum[run_end.long()] - neg_strict_above

    credit = n_neg[rg.gid.long()] - neg_strict_above - 0.5 * neg_tied
    pairs_won = _seg_sum(posm * credit, rg)
    return _safe_divide(pairs_won, n_pos * n_neg)


def grouped_precision_recall_curve(rg: RankedGroups, max_k: int,
                                   adaptive_k: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """(G, max_k) precision / recall curves for all queries at once: the within-group
    relevance scattered into a dense (G, K) grid, cumulated along k."""
    device = rg.target.device
    g = max(rg.num_groups, 1)
    # only the ranks in the grid: the JAX package adds the others' zeros into cell (0, 0), which on
    # the card serializes millions of atomic adds on one address; every (group, rank) is one cell
    in_grid = rg.rank < max_k
    grid = torch.zeros((g, max_k), dtype=torch.float32, device=device)
    grid[rg.gid[in_grid].long(), rg.rank[in_grid].long()] = rg.target[in_grid]
    rel_cum = torch.cumsum(grid, 1)
    topk = torch.arange(1, max_k + 1, dtype=torch.float32, device=device)
    denom = torch.minimum(topk[None, :], rg.sizes[:, None]) if adaptive_k else topk[None, :]
    precision = _safe_divide(rel_cum, denom)
    recall = _safe_divide(rel_cum, rg.n_rel[:, None])
    return precision, recall, torch.arange(1, max_k + 1, dtype=torch.int32, device=device)


_GROUPED = {
    "precision": lambda rg, k, adaptive: grouped_precision(rg, k, adaptive),
    "recall": lambda rg, k, adaptive: grouped_recall(rg, k),
    "hit_rate": lambda rg, k, adaptive: grouped_hit_rate(rg, k),
    "fall_out": lambda rg, k, adaptive: grouped_fall_out(rg, k),
    "average_precision": lambda rg, k, adaptive: grouped_average_precision(rg, k),
    "reciprocal_rank": lambda rg, k, adaptive: grouped_reciprocal_rank(rg, k),
    "r_precision": lambda rg, k, adaptive: grouped_r_precision(rg),
    "auroc": lambda rg, k, adaptive: grouped_auroc(rg, k),
}


def _retrieval_scores_plain(preds: Tensor, target: Tensor, indexes: Tensor, measure: str, top_k: Optional[int],
                            adaptive_k: bool) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch ``retrieval_groups``: the plain ranked layout and the grouped formulas, on any device."""
    rg = _rank_groups_plain(preds, target, indexes)
    if measure == "ndcg":
        ideal = _rank_groups_plain(target, target, indexes, rg.num_groups)
        return _safe_divide(_dcg(rg, top_k), _dcg(ideal, top_k)), rg.n_rel, rg.sizes
    return _GROUPED[measure](rg, top_k, adaptive_k), rg.n_rel, rg.sizes


def retrieval_scores(preds, target, indexes, measure: str, top_k: Optional[int] = None,
                     adaptive_k: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """Every query's ``measure``, float32 ``(scores, n_rel, sizes)``, each ``(G,)``, queries in
    ascending id order.

    ``measure`` is one of ``precision`` (with ``adaptive_k``), ``recall``,
    ``hit_rate``, ``fall_out``, ``average_precision``, ``reciprocal_rank``,
    ``r_precision``, ``ndcg`` or ``auroc``. On a CUDA tensor: the rows in
    order of query id (:func:`query_layout`) and one ``retrieval_groups``
    launch, which raises if it cannot run; on the CPU the plain version.
    With no rows, one empty group of zeros, as the JAX package gives.
    """
    preds, target, indexes = _flat(preds, target, indexes)
    if preds.shape[0] == 0:
        rg = _empty_groups(preds.device)
        return torch.zeros_like(rg.n_rel), rg.n_rel, rg.sizes
    if preds.device.type == "cpu":
        return _retrieval_scores_plain(preds, target, indexes, measure, top_k, adaptive_k)
    p, t, offsets, longest = query_layout(preds, target, indexes)
    scores, n_rel = retrieval_groups(p, t, offsets, measure, top_k, adaptive_k, longest=longest)
    return scores, n_rel, torch.diff(offsets).to(torch.float32)


# ----------------------------------------------------- single-query functional API
def _check_binary_target(target: Tensor) -> None:
    """Binary validation of the target, one host read."""
    if bool(((target != 0) & (target != 1)).any()):
        raise ValueError("`target` must contain binary values")


def _check_top_k(top_k: Optional[int]) -> None:
    if top_k is not None and not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")


def _single(preds, target, measure: str, top_k: Optional[int] = None, adaptive_k: bool = False,
            binary: bool = True) -> Tensor:
    preds, target, _ = _flat(preds, target, torch.zeros((0,)))
    if binary:
        _check_binary_target(target)
    zeros = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
    return retrieval_scores(preds, target, zeros, measure, top_k, adaptive_k)[0][0]


def retrieval_precision(preds: Tensor, target: Tensor, top_k: Optional[int] = None,
                        adaptive_k: bool = False) -> Tensor:
    _check_top_k(top_k)
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    return _single(preds, target, "precision", top_k, adaptive_k)


def retrieval_recall(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    _check_top_k(top_k)
    return _single(preds, target, "recall", top_k)


def retrieval_hit_rate(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    _check_top_k(top_k)
    return _single(preds, target, "hit_rate", top_k)


def retrieval_fall_out(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    _check_top_k(top_k)
    return _single(preds, target, "fall_out", top_k)


def retrieval_average_precision(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    _check_top_k(top_k)
    return _single(preds, target, "average_precision", top_k)


def retrieval_reciprocal_rank(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    _check_top_k(top_k)
    return _single(preds, target, "reciprocal_rank", top_k)


def retrieval_r_precision(preds: Tensor, target: Tensor) -> Tensor:
    return _single(preds, target, "r_precision")


def retrieval_normalized_dcg(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    _check_top_k(top_k)
    return _single(preds, target, "ndcg", top_k, binary=False)


def retrieval_auroc(preds: Tensor, target: Tensor, top_k: Optional[int] = None,
                    max_fpr: Optional[float] = None) -> Tensor:
    _check_top_k(top_k)
    if max_fpr is not None:
        # the partial area goes through the classification ROC on the top-k subset, as in JAX
        from torchmetrics_tpu_torch.functional.classification.auroc import binary_auroc

        preds, target, _ = _flat(preds, target, torch.zeros((0,)))
        _check_binary_target(target)
        rg = rank_groups(preds, target, torch.zeros(preds.shape, dtype=torch.int32, device=preds.device), 1)
        k = rg.preds.shape[0] if top_k is None else min(top_k, rg.preds.shape[0])
        return binary_auroc(rg.preds[:k], rg.target[:k].to(torch.int32), max_fpr=max_fpr)
    return _single(preds, target, "auroc", top_k)


def retrieval_precision_recall_curve(preds: Tensor, target: Tensor, max_k: Optional[int] = None,
                                     adaptive_k: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    preds, target, _ = _flat(preds, target, torch.zeros((0,)))
    n = preds.numel()
    if max_k is None:
        max_k = n
    if not (isinstance(max_k, int) and max_k > 0):
        raise ValueError("`max_k` has to be a positive integer or None")
    _check_binary_target(target)
    rg = rank_groups(preds, target, torch.zeros(preds.shape, dtype=torch.int32, device=preds.device), 1)
    precision, recall, topk = grouped_precision_recall_curve(rg, max_k, adaptive_k)
    if adaptive_k and max_k > n:
        topk = torch.cat([torch.arange(1, n + 1, dtype=topk.dtype, device=topk.device),
                          torch.full((max_k - n,), n, dtype=topk.dtype, device=topk.device)])
    return precision[0], recall[0], topk
