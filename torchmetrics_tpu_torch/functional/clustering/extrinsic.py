"""Label-comparison (extrinsic) clustering metrics (counterpart of
``torchmetrics_tpu/functional/clustering/extrinsic.py``).

Every score starts from the contingency matrix
(:func:`~torchmetrics_tpu_torch.functional.clustering.utils.calculate_contingency_matrix`:
one ``confmat_multiclass`` launch on the card). E[MI] keeps JAX's float32
``(R, C, K)`` form, ``torch.lgamma`` for ``gammaln``: its terms of size
n log n cancel, so two float32 evaluations drift apart at large n.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.clustering.extrinsic import mutual_info_score, adjusted_rand_score
    >>> preds = torch.tensor([0, 0, 1, 1])
    >>> target = torch.tensor([1, 1, 0, 0])
    >>> round(float(mutual_info_score(preds, target)), 4)
    0.6931
    >>> round(float(adjusted_rand_score(preds, target)), 4)
    1.0
"""

from __future__ import annotations

from typing import Literal

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.clustering.utils import (
    _entropy_from_counts,
    _pair_counts,
    _validate_average_method_arg,
    _validate_clustering_inputs,
    calculate_contingency_matrix,
    calculate_generalized_mean,
)

_EPS32 = float(torch.finfo(torch.float32).eps)


def _mutual_info_from_contingency(contingency: Tensor) -> Tensor:
    n = contingency.sum()
    row = contingency.sum(1, keepdim=True)
    col = contingency.sum(0, keepdim=True)
    outer = row * col
    nz = contingency > 0
    ones = torch.ones_like(contingency)
    ratio = torch.where(nz, n * contingency / torch.where(outer > 0, outer, ones), ones)
    # the sum runs over the non-zero cells alone, in row-major order, as the entropies' runs over the non-zero
    # counts: XLA's sum of JAX's masked terms rounds so (its zeros leave the partial sums alone), and identical
    # labelings then give MI equal to H bit for bit, so AMI is exactly 1
    return ((contingency / n) * torch.log(ratio))[nz].sum()


def mutual_info_score(preds: Tensor, target: Tensor) -> Tensor:
    """Mutual information between two clusterings (nats)."""
    _validate_clustering_inputs(preds, target)
    return _mutual_info_from_contingency(calculate_contingency_matrix(preds, target))


def _gammaln(x: Tensor) -> Tensor:
    """``gammaln`` rounded once to ``x``'s float type (evaluated in float64)."""
    return torch.lgamma(x.double()).to(x.dtype)


def expected_mutual_info_score(contingency: Tensor, n_samples: int) -> Tensor:
    """E[MI] under the permutation (hypergeometric) model, over a padded ``nij`` axis with a validity mask."""
    n = torch.tensor(float(n_samples), dtype=contingency.dtype, device=contingency.device)
    a = contingency.sum(1)  # (R,)
    b = contingency.sum(0)  # (C,)
    ai = a[:, None]  # (R,1)
    bj = b[None, :]  # (1,C)
    start = torch.clamp_min(ai + bj - n, 1.0)  # (R,C)
    end = torch.minimum(ai, bj)  # (R,C) inclusive
    max_len = int((end - start).max()) + 1
    k = torch.arange(max_len, dtype=contingency.dtype, device=contingency.device)  # (K,)
    nij = start[:, :, None] + k[None, None, :]  # (R,C,K)
    valid = nij <= end[:, :, None]
    nij_safe = torch.where(valid, nij, torch.ones_like(nij))
    ai3, bj3 = ai[:, :, None], bj[:, :, None]
    log_term = torch.log(n) + torch.log(nij_safe) - torch.log(ai3) - torch.log(bj3)
    # log P(nij) via gammaln (hypergeometric pmf)
    gln = (
        _gammaln(ai3 + 1)
        + _gammaln(bj3 + 1)
        + _gammaln(n - ai3 + 1)
        + _gammaln(n - bj3 + 1)
        - _gammaln(n + 1)
        - _gammaln(nij_safe + 1)
        - _gammaln(ai3 - nij_safe + 1)
        - _gammaln(bj3 - nij_safe + 1)
        - _gammaln(n - ai3 - bj3 + nij_safe + 1)
    )
    term = (nij_safe / n) * log_term * torch.exp(gln)
    return torch.where(valid, term, torch.zeros_like(term)).sum()


def adjusted_mutual_info_score(
    preds: Tensor,
    target: Tensor,
    average_method: Literal["min", "geometric", "arithmetic", "max"] = "arithmetic",
) -> Tensor:
    """AMI: (MI - E[MI]) / (mean(H(U),H(V)) - E[MI])."""
    _validate_clustering_inputs(preds, target)
    _validate_average_method_arg(average_method)
    contingency = calculate_contingency_matrix(preds, target)
    mi = _mutual_info_from_contingency(contingency)
    h_pred = _entropy_from_counts(contingency.sum(0))
    h_target = _entropy_from_counts(contingency.sum(1))
    normalizer = calculate_generalized_mean(torch.stack([h_pred, h_target]), average_method)
    emi = expected_mutual_info_score(contingency, int(preds.shape[0]))
    denom = normalizer - emi
    # sklearn convention: tiny denominators snap to the dominant sign's epsilon
    denom = torch.where(denom < 0, denom.clamp_max(-_EPS32), denom.clamp_min(_EPS32))
    return (mi - emi) / denom


def normalized_mutual_info_score(
    preds: Tensor,
    target: Tensor,
    average_method: Literal["min", "geometric", "arithmetic", "max"] = "arithmetic",
) -> Tensor:
    """NMI: MI / mean(H(U), H(V))."""
    _validate_clustering_inputs(preds, target)
    _validate_average_method_arg(average_method)
    contingency = calculate_contingency_matrix(preds, target)
    mi = _mutual_info_from_contingency(contingency)
    h_pred = _entropy_from_counts(contingency.sum(0))
    h_target = _entropy_from_counts(contingency.sum(1))
    normalizer = calculate_generalized_mean(torch.stack([h_pred, h_target]), average_method)
    return torch.where(mi.abs() < 1e-10, torch.zeros_like(mi), mi / normalizer.clamp_min(_EPS32))


def rand_score(preds: Tensor, target: Tensor) -> Tensor:
    """Rand index: fraction of sample pairs on which the clusterings agree."""
    _validate_clustering_inputs(preds, target)
    tp, fp, fn, tn = _pair_counts(calculate_contingency_matrix(preds, target))
    return (tp + tn) / (tp + fp + fn + tn)


def adjusted_rand_score(preds: Tensor, target: Tensor) -> Tensor:
    """ARI: Rand index corrected for chance."""
    _validate_clustering_inputs(preds, target)
    tp, fp, fn, tn = _pair_counts(calculate_contingency_matrix(preds, target))
    denom = (tp + fn) * (fn + tn) + (tp + fp) * (fp + tn)
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    return torch.where(denom == 0, torch.ones_like(denom), 2.0 * (tp * tn - fp * fn) / safe)


def fowlkes_mallows_index(preds: Tensor, target: Tensor) -> Tensor:
    """FMI = TP / sqrt((TP+FP)(TP+FN)) over sample pairs."""
    _validate_clustering_inputs(preds, target)
    tp, fp, fn, _ = _pair_counts(calculate_contingency_matrix(preds, target))
    denom = torch.sqrt((tp + fp) * (tp + fn))
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(denom > 0, tp / safe, torch.zeros_like(denom))


def _conditional_entropies(preds: Tensor, target: Tensor):
    contingency = calculate_contingency_matrix(preds, target)
    n = contingency.sum()
    row = contingency.sum(1)  # target cluster sizes
    col = contingency.sum(0)  # pred cluster sizes
    # H(target | preds) = -sum_ij (nij/n) log(nij / col_j)
    nz = contingency > 0
    safe_c = torch.where(nz, contingency, torch.ones_like(contingency))
    zeros = torch.zeros_like(contingency)
    h_t_given_p = -torch.where(nz, (contingency / n) * torch.log(safe_c / col[None, :]), zeros).sum()
    h_p_given_t = -torch.where(nz, (contingency / n) * torch.log(safe_c / row[:, None]), zeros).sum()
    return h_t_given_p, h_p_given_t, _entropy_from_counts(row), _entropy_from_counts(col)


def homogeneity_score(preds: Tensor, target: Tensor) -> Tensor:
    """1 - H(target|preds)/H(target): each cluster contains a single class."""
    _validate_clustering_inputs(preds, target)
    h_t_given_p, _, h_t, _ = _conditional_entropies(preds, target)
    return torch.where(h_t > 0, 1.0 - h_t_given_p / torch.where(h_t > 0, h_t, torch.ones_like(h_t)),
                       torch.ones_like(h_t))


def completeness_score(preds: Tensor, target: Tensor) -> Tensor:
    """1 - H(preds|target)/H(preds): all members of a class share a cluster."""
    _validate_clustering_inputs(preds, target)
    _, h_p_given_t, _, h_p = _conditional_entropies(preds, target)
    return torch.where(h_p > 0, 1.0 - h_p_given_t / torch.where(h_p > 0, h_p, torch.ones_like(h_p)),
                       torch.ones_like(h_p))


def v_measure_score(preds: Tensor, target: Tensor, beta: float = 1.0) -> Tensor:
    """Weighted harmonic mean of homogeneity and completeness."""
    _validate_clustering_inputs(preds, target)
    hom = homogeneity_score(preds, target)
    com = completeness_score(preds, target)
    denom = beta * hom + com
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(denom > 0, (1 + beta) * hom * com / safe, torch.zeros_like(denom))
