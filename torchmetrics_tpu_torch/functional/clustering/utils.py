"""Shared clustering helpers: contingency matrix, entropies, generalized means
(counterpart of ``torchmetrics_tpu/functional/clustering/utils.py``).

The contingency matrix relabels both label series to dense ids (sorted, as
``jnp.unique``), then counts each pair's cell ``t * k_pred + p`` of the
``(k_target, k_pred)`` table with the ``confmat_multiclass`` CUDA kernel for
labels on the card (its plain version on the CPU): exact int32 counts,
returned in float32 as JAX's one-hot product is, with no ``(n, k)`` one-hot.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import _multiclass_confmat_accumulate
from torchmetrics_tpu_torch.kernels.pairwise import _power

_TABLE_CELLS = 2**30  # cells of the contingency table a launch: the kernel's cell index is int32


def _validate_clustering_inputs(preds: Tensor, target: Tensor) -> None:
    if preds.ndim != 1 or target.ndim != 1:
        raise ValueError(f"Expected 1d label arrays, got preds.ndim={preds.ndim} target.ndim={target.ndim}")
    if preds.shape != target.shape:
        raise ValueError(
            f"Expected preds and target to have the same shape, got {tuple(preds.shape)} and {tuple(target.shape)}"
        )


def _validate_intrinsic_inputs(data: Tensor, labels: Tensor) -> None:
    if data.ndim != 2 or labels.ndim != 1:
        raise ValueError(f"Expected data of shape (n, d) and 1d labels, got {tuple(data.shape)} and {tuple(labels.shape)}")
    if data.shape[0] != labels.shape[0]:
        raise ValueError("data and labels must agree on the number of samples")


def _validate_average_method_arg(average_method: str) -> None:
    if average_method not in ("min", "geometric", "arithmetic", "max"):
        raise ValueError(
            "Expected argument `average_method` to be one of `min`, `geometric`, `arithmetic`, `max`, "
            f"but got {average_method}"
        )


def _dense_relabel(labels: Tensor) -> Tuple[Tensor, int]:
    """Map arbitrary labels to dense ``0..k-1`` ids in sorted order (a host read for ``k``)."""
    uniq, dense = torch.unique(labels, sorted=True, return_inverse=True)
    return dense.reshape(labels.shape), int(uniq.shape[0])


def _pair_table(rows: Tensor, cols: Tensor, k_rows: int, k_cols: int) -> Tensor:
    """int32 ``(k_rows, k_cols)`` counts of the pairs ``(rows[i], cols[i])`` of dense ids.

    The kernel counts into a square ``(side, side)`` state at the int32 cell
    ``target * side + label``, so a cell ``c`` of the table goes in as target
    ``c // side`` and label ``c % side``, with ``side = ceil(sqrt(cells))``:
    the state holds no more cells than the table (plus less than one row).
    A table of more than ``_TABLE_CELLS`` cells is counted in slices of that
    many, a launch each; a pair outside the slice goes to cell
    ``side * side``, which the kernel's pair rule drops.
    """
    cells = k_rows * k_cols
    flat = rows.to(torch.int64) * k_cols + cols
    table = torch.empty(cells, dtype=torch.int32, device=rows.device)
    for start in range(0, cells, _TABLE_CELLS):
        size = min(_TABLE_CELLS, cells - start)
        side = math.isqrt(size - 1) + 1
        local = flat - start
        if size < cells:
            local = torch.where((local >= 0) & (local < size), local, side * side)
        counts = torch.zeros((side, side), dtype=torch.int32, device=rows.device)
        counts = _multiclass_confmat_accumulate(counts, (local % side).to(torch.int32),
                                                (local // side).to(torch.int32), None)
        table[start:start + size] = counts.view(-1)[:size]
    return table.view(k_rows, k_cols)


def calculate_contingency_matrix(preds: Tensor, target: Tensor) -> Tensor:
    """``(n_target_clusters, n_pred_clusters)`` float32 co-occurrence counts (:func:`_pair_table`)."""
    p_dense, kp = _dense_relabel(preds)
    t_dense, kt = _dense_relabel(target)
    return _pair_table(t_dense, p_dense, kt, kp).to(torch.float32)


def calculate_entropy(labels: Tensor) -> Tensor:
    """Shannon entropy (nats) of a label assignment."""
    _, counts = torch.unique(labels, return_counts=True)
    p = counts.to(torch.float32) / labels.shape[0]
    return -(p * torch.log(p)).sum()


def _entropy_from_counts(counts: Tensor) -> Tensor:
    n = counts.sum()
    p = counts / n.clamp_min(1)
    nz = counts > 0
    # over the non-zero counts alone, as ``_mutual_info_from_contingency`` sums its non-zero cells
    return -(p * torch.log(torch.where(nz, p, torch.ones_like(p))))[nz].sum()


def calculate_generalized_mean(x: Tensor, p: Union[int, float, str]) -> Tensor:
    """Power mean; string shortcuts min/geometric/arithmetic/max."""
    if isinstance(p, str):
        if p == "min":
            return x.min()
        if p == "geometric":
            return torch.exp(torch.log(x).mean())
        if p == "arithmetic":
            return x.mean()
        if p == "max":
            return x.max()
        raise ValueError(f"Unknown generalized mean {p!r}")
    return torch.pow(_power(x, p).mean(), 1.0 / p)


def _pair_counts(contingency: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(tp, fp, fn, tn) pair counts from a contingency matrix (pairs of samples)."""
    n = contingency.sum()
    sum_sq = (contingency * contingency).sum()
    row = contingency.sum(1)
    col = contingency.sum(0)
    sum_row_sq = (row * row).sum()
    sum_col_sq = (col * col).sum()
    tp = (sum_sq - n) / 2.0
    fp = (sum_col_sq - sum_sq) / 2.0
    fn = (sum_row_sq - sum_sq) / 2.0
    tn = (n * n + sum_sq - sum_row_sq - sum_col_sq) / 2.0
    return tp, fp, fn, tn
