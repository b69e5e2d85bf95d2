"""Shared numeric helpers (counterpart of ``torchmetrics_tpu/utilities/compute.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor


def _safe_divide(num: Tensor, denom: Tensor, zero_division: float = 0.0) -> Tensor:
    """Elementwise ``num / denom``, giving ``zero_division`` where ``denom == 0``.

    Integer operands are taken as float32 first, as in the JAX package.
    """
    num = num if num.is_floating_point() else num.to(torch.float32)
    denom = denom if denom.is_floating_point() else denom.to(torch.float32)
    zero_mask = denom == 0
    safe_denom = torch.where(zero_mask, torch.ones_like(denom), denom)
    return torch.where(zero_mask, torch.full_like(safe_denom, zero_division), num / safe_denom)


def _safe_xlogy(x: Tensor, y: Tensor) -> Tensor:
    """``x * log(y)``, 0 where ``x == 0`` whatever ``y`` is (``jax.scipy.special.xlogy``;
    ``torch.xlogy`` gives NaN there for a NaN ``y``)."""
    nonzero = x != 0
    return torch.where(nonzero, x * torch.log(torch.where(nonzero, y, torch.ones_like(y))), torch.zeros_like(x))


def _adjust_weights_safe_divide(
    score: Tensor, average: Optional[str], multilabel: bool, tp: Tensor, fp: Tensor, fn: Tensor,
    top_k: int = 1,
) -> Tensor:
    """Weighted or macro reduction over per-class scores."""
    if average is None or average == "none":
        return score
    if average == "weighted":
        weights = tp + fn
    else:
        weights = torch.ones_like(score)
        if not multilabel:
            # classes absent from both preds and target get no weight; with
            # top_k > 1 a class can be in the top-k preds without being
            # present, so the absence test drops the fp term
            absent = (tp + fp + fn == 0) if top_k == 1 else (tp + fn == 0)
            weights = torch.where(absent, torch.zeros_like(weights), weights)
    return _safe_divide(weights * score, weights.sum(dim=-1, keepdim=True)).sum(-1)


def _trapezoid(y: Tensor, x: Tensor, dim: int = -1) -> Tensor:
    """``jnp.trapezoid``: ``0.5 * sum(diff(x) * (y[1:] + y[:-1]))`` along ``dim``."""
    n = y.shape[dim]
    y_hi, y_lo = y.narrow(dim, 1, n - 1), y.narrow(dim, 0, n - 1)
    return 0.5 * (torch.diff(x, dim=dim) * (y_hi + y_lo)).sum(dim)


def _auc_compute(
    x: Tensor, y: Tensor, direction: Optional[float] = None, reorder: bool = False, dim: int = -1
) -> Tensor:
    """Trapezoidal area under the ``(x, y)`` curve along ``dim``.

    The JAX version handles one curve; ``dim`` lets the port take the areas
    of many curves (one per class) in one pass.
    """
    if reorder:
        order = torch.argsort(x, dim=dim, stable=True)
        x, y = x.gather(dim, order), y.gather(dim, order)
    if direction is None:
        dx = torch.diff(x, dim=dim)
        direction = torch.where((dx <= 0).all(dim), -1.0, 1.0)
    return (_trapezoid(y, x, dim) * direction).to(y.dtype)


def normalize_logits_if_needed(tensor: Tensor, normalization: Optional[str]) -> Tensor:
    """Apply sigmoid or softmax iff any value of the whole tensor lies outside [0, 1].

    The predicate is taken over the whole batch tensor, not per sample, as in
    the JAX package. It stays on the device (``torch.where``), so the update
    never waits for the host.
    """
    if normalization is None:
        return tensor
    outside = torch.logical_or((tensor < 0).any(), (tensor > 1).any())
    if normalization == "sigmoid":
        return torch.where(outside, torch.sigmoid(tensor), tensor)
    if normalization == "softmax":
        return torch.where(outside, _softmax(tensor, dim=1), tensor)
    raise ValueError(f"Unknown normalization: {normalization}")


def _softmax(x: Tensor, dim: int) -> Tensor:
    """``jax.nn.softmax``: ``exp(x - max) / sum``, divided.

    ``torch.softmax`` on the CPU multiplies by ``1 / sum`` instead, which
    rounds some near-tie probabilities below ``1 / sum`` where JAX ties them
    (an exponential of ``1 - 2^-24`` over a sum of 6.25). A NaN in a row, a
    row of ``-inf`` or a ``+inf`` makes the row NaN, as in JAX.
    """
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)
