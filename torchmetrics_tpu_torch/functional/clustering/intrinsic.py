"""Geometry-based (intrinsic) clustering metrics over raw embeddings (counterpart of
``torchmetrics_tpu/functional/clustering/intrinsic.py``).

Per-cluster counts and sums are ``index_add_`` over the dense labels instead
of JAX's ``(n, k)`` one-hot product (float32 sums in another order: the
scores agree within 1e-5 relative). The ``(k, k)`` centroid distances of
``davies_bouldin_score`` (a norm: squares and a square root) and
``dunn_index`` (its ``p``) are one ``pairwise_lp`` launch on the card, with
no ``(k, k, d)`` temporary.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.clustering.intrinsic import calinski_harabasz_score
    >>> data = torch.tensor([[0.0, 0.0], [0.1, 0.1], [5.0, 5.0], [5.1, 4.9]])
    >>> labels = torch.tensor([0, 0, 1, 1])
    >>> round(float(calinski_harabasz_score(data, labels)), 2)
    4901.0
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.clustering.utils import _dense_relabel, _validate_intrinsic_inputs
from torchmetrics_tpu_torch.kernels.pairwise import _power, pairwise_lp_distance


def _cluster_stats(data: Tensor, labels: Tensor) -> Tuple[Tensor, int, Tensor, Tensor]:
    """Dense labels, k, per-cluster counts ``(k,)`` and means ``(k, d)``."""
    dense, k = _dense_relabel(labels)
    ones = torch.ones_like(dense, dtype=data.dtype)
    counts = torch.zeros((k,), dtype=data.dtype, device=data.device).index_add_(0, dense, ones)
    sums = torch.zeros((k, data.shape[1]), dtype=data.dtype, device=data.device).index_add_(0, dense, data)
    means = sums / counts.clamp_min(1.0)[:, None]
    return dense, k, counts, means


def _as_data(data: Tensor) -> Tensor:
    return data if data.dtype == torch.float32 else data.to(torch.float32)


def calinski_harabasz_score(data: Tensor, labels: Tensor) -> Tensor:
    """Between/within dispersion ratio (higher = better separated)."""
    _validate_intrinsic_inputs(data, labels)
    data = _as_data(data)
    n = data.shape[0]
    dense, k, counts, means = _cluster_stats(data, labels)
    overall = data.mean(0)
    between = (counts * ((means - overall[None, :]) ** 2).sum(1)).sum()
    within = ((data - means[dense]) ** 2).sum()
    return (between / within.clamp_min(1e-12)) * ((n - k) / max(k - 1, 1))


def davies_bouldin_score(data: Tensor, labels: Tensor) -> Tensor:
    """Mean over clusters of the worst (si+sj)/dij similarity (lower = better)."""
    _validate_intrinsic_inputs(data, labels)
    data = _as_data(data)
    dense, k, counts, means = _cluster_stats(data, labels)
    diff = data - means[dense]
    dist_to_centroid = (diff * diff).sum(1).sqrt()  # jnp.linalg.norm
    s = torch.zeros((k,), dtype=data.dtype, device=data.device).index_add_(0, dense, dist_to_centroid)
    s = s / counts.clamp_min(1.0)  # (k,)
    centroid_dist = pairwise_lp_distance(means, means, 2, "sqrt")  # (k, k)
    inf = torch.full_like(centroid_dist, float("inf"))
    ratio = (s[:, None] + s[None, :]) / torch.where(centroid_dist > 0, centroid_dist, inf)
    eye = torch.eye(k, dtype=torch.bool, device=data.device)
    ratio = torch.where(eye, -inf, ratio)
    return ratio.amax(1).mean()


def dunn_index(data: Tensor, labels: Tensor, p: float = 2) -> Tensor:
    """min centroid-pair distance / max point-to-own-centroid distance, both p-norms."""
    _validate_intrinsic_inputs(data, labels)
    data = _as_data(data)
    dense, k, _, means = _cluster_stats(data, labels)
    pair_dist = pairwise_lp_distance(means, means, p, "pow")
    eye = torch.eye(k, dtype=torch.bool, device=data.device)
    inter = torch.where(eye, torch.full_like(pair_dist, float("inf")), pair_dist).min()
    root = torch.tensor(1.0 / p, dtype=torch.float32).item()
    to_centroid = torch.pow(_power((data - means[dense]).abs(), p).sum(-1), root)
    intra = to_centroid.max()
    return inter / intra.clamp_min(1e-12)
