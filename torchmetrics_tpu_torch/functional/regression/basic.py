"""Elementwise-error regression metrics (counterpart of ``torchmetrics_tpu/functional/regression/basic.py``).

Each is a (sum of errors, count) pair of sufficient statistics: the update
functions return the pair, so the metric classes add and the one-shot
functions divide. Sums are float32, as in the JAX package.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.regression.basic import mean_squared_error, mean_absolute_error
    >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
    >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
    >>> round(float(mean_squared_error(preds, target)), 4)
    0.375
    >>> round(float(mean_absolute_error(preds, target)), 4)
    0.5
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.compute import _safe_divide, _safe_xlogy
from torchmetrics_tpu_torch.utilities.data import input_device
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError

#: the floor of a percentage error's denominator, as in the JAX package
_EPS = 1.17e-6


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {preds.shape} and {target.shape}."
        )


def _pair(preds, target, flatten: bool = True, num_outputs: int = 1) -> Tuple[Tensor, Tensor]:
    """``(preds, target)`` as float32 tensors on the device of ``preds``, checked
    for equal shapes and reshaped to ``(-1,)`` or ``(-1, num_outputs)``."""
    device = input_device(preds)
    preds = torch.as_tensor(preds, device=device).to(torch.float32)
    target = torch.as_tensor(target, device=device).to(torch.float32)
    _check_same_shape(preds, target)
    if not flatten:
        return preds, target
    shape = (-1,) if num_outputs == 1 else (-1, num_outputs)
    return preds.reshape(shape), target.reshape(shape)


# ------------------------------------------------------------------ MSE / MAE / MSLE
def _mean_squared_error_update(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tuple[Tensor, int]:
    """``(sum of squared errors, number of rows)``."""
    preds, target = _pair(preds, target, num_outputs=num_outputs)
    return ((preds - target) ** 2).sum(dim=0), preds.shape[0]


def mean_squared_error(preds: Tensor, target: Tensor, squared: bool = True, num_outputs: int = 1) -> Tensor:
    sse, n = _mean_squared_error_update(preds, target, num_outputs)
    mse = sse / n
    return mse if squared else torch.sqrt(mse)


def _mean_absolute_error_update(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tuple[Tensor, int]:
    preds, target = _pair(preds, target, num_outputs=num_outputs)
    return (preds - target).abs().sum(dim=0), preds.shape[0]


def mean_absolute_error(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tensor:
    sae, n = _mean_absolute_error_update(preds, target, num_outputs)
    return sae / n


def _mean_squared_log_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    preds, target = _pair(preds, target)
    return ((torch.log1p(preds) - torch.log1p(target)) ** 2).sum(), preds.shape[0]


def mean_squared_log_error(preds: Tensor, target: Tensor) -> Tensor:
    s, n = _mean_squared_log_error_update(preds, target)
    return s / n


# ------------------------------------------------------------------ percentage errors
def _mean_absolute_percentage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    preds, target = _pair(preds, target)
    ape = (preds - target).abs() / torch.clamp(target.abs(), min=_EPS)
    return ape.sum(), preds.shape[0]


def mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    s, n = _mean_absolute_percentage_error_update(preds, target)
    return s / n


def _symmetric_mape_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    preds, target = _pair(preds, target)
    sape = 2.0 * (preds - target).abs() / torch.clamp(target.abs() + preds.abs(), min=_EPS)
    return sape.sum(), preds.shape[0]


def symmetric_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    s, n = _symmetric_mape_update(preds, target)
    return s / n


def _weighted_mape_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds, target = _pair(preds, target)
    return (preds - target).abs().sum(), target.abs().sum()


def weighted_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    num, denom = _weighted_mape_update(preds, target)
    return num / torch.clamp(denom, min=_EPS)


# ------------------------------------------------------------------ log-cosh / minkowski
def _log_cosh_error_update(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tuple[Tensor, int]:
    preds, target = _pair(preds, target, num_outputs=num_outputs)
    diff = preds - target
    # log(cosh(x)) = x + softplus(-2x) - log(2), softplus as logaddexp(x, 0) (JAX's)
    val = diff + torch.logaddexp(-2.0 * diff, torch.zeros_like(diff)) - math.log(2.0)
    return val.sum(dim=0), preds.shape[0]


def log_cosh_error(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tensor:
    s, n = _log_cosh_error_update(preds, target, num_outputs)
    return s / n


def _check_minkowski_p(p) -> None:
    if not (isinstance(p, (int, float)) and p >= 1):
        raise TorchMetricsUserError(f"Argument ``p`` should be a float or int greater than 1, but got {p}")


def _minkowski_distance_update(preds: Tensor, target: Tensor, p: float) -> Tensor:
    preds, target = _pair(preds, target)
    return ((preds - target).abs() ** p).sum()


def minkowski_distance(preds: Tensor, target: Tensor, p: float) -> Tensor:
    _check_minkowski_p(p)
    return _minkowski_distance_update(preds, target, p) ** (1.0 / p)


# ------------------------------------------------------------------ tweedie
def _check_tweedie_power(power: float) -> None:
    if power < 0 or 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")


def _tweedie_deviance_update(preds: Tensor, target: Tensor, power: float = 0.0) -> Tuple[Tensor, int]:
    preds, target = _pair(preds, target)
    _check_tweedie_power(power)
    if power == 0:
        dev = (preds - target) ** 2
    elif power == 1:
        dev = 2 * (_safe_xlogy(target, target / preds) - target + preds)
    elif power == 2:
        dev = 2 * (torch.log(preds / target) + target / preds - 1)
    else:
        t1 = torch.clamp(target, min=0.0) ** (2 - power) / ((1 - power) * (2 - power))
        t2 = target * preds ** (1 - power) / (1 - power)
        t3 = preds ** (2 - power) / (2 - power)
        dev = 2 * (t1 - t2 + t3)
    return dev.sum(), preds.shape[0]


def tweedie_deviance_score(preds: Tensor, target: Tensor, power: float = 0.0) -> Tensor:
    s, n = _tweedie_deviance_update(preds, target, power)
    return s / n


# ------------------------------------------------------------------ CSI
def _critical_success_index_update(
    preds: Tensor, target: Tensor, threshold: float, keep_sequence_dim: Optional[int] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """float32 ``(hits, misses, false alarms)``, summed over every dim but ``keep_sequence_dim``."""
    preds, target = _pair(preds, target, flatten=False)
    p, t = preds >= threshold, target >= threshold
    dims = tuple(i for i in range(preds.ndim) if i != keep_sequence_dim) if keep_sequence_dim is not None else None

    def count(mask: Tensor) -> Tensor:
        return (mask.sum() if dims is None else mask.sum(dim=dims)).to(torch.float32)

    return count(p & t), count(~p & t), count(p & ~t)


def critical_success_index(
    preds: Tensor, target: Tensor, threshold: float, keep_sequence_dim: Optional[int] = None
) -> Tensor:
    hits, misses, fa = _critical_success_index_update(preds, target, threshold, keep_sequence_dim)
    return _safe_divide(hits, hits + misses + fa)


# ------------------------------------------------------------------ KL divergence
def _kl_divergence_update(preds: Tensor, target: Tensor, log_prob: bool = False) -> Tuple[Tensor, int]:
    """Per-row ``KL(preds || target)`` and the row count."""
    preds, target = _pair(preds, target, flatten=False)
    if preds.ndim != 2 or target.ndim != 2:
        raise ValueError(
            f"Expected both predictions and target to be 2D but got {preds.ndim} and {target.ndim} respectively"
        )
    if log_prob:
        measures = (torch.exp(preds) * (preds - target)).sum(dim=-1)
    else:
        p = preds / preds.sum(dim=-1, keepdim=True)
        t = target / target.sum(dim=-1, keepdim=True)
        measures = _safe_xlogy(p, p / torch.clamp(t, min=1e-24)).sum(dim=-1)
    return measures, preds.shape[0]


def kl_divergence(preds: Tensor, target: Tensor, log_prob: bool = False, reduction: str = "mean") -> Tensor:
    measures, n = _kl_divergence_update(preds, target, log_prob)
    if reduction == "mean":
        return measures.sum() / n
    if reduction == "sum":
        return measures.sum()
    if reduction in ("none", None):
        return measures
    raise ValueError(f"Expected argument `reduction` to be one of ('mean', 'sum', 'none', None), got {reduction}")


# ------------------------------------------------------------------ cosine similarity
def _cosine_similarity_compute(preds: Tensor, target: Tensor, reduction: str = "sum") -> Tensor:
    dot = (preds * target).sum(dim=-1)
    sim = _safe_divide(dot, torch.linalg.vector_norm(preds, dim=-1) * torch.linalg.vector_norm(target, dim=-1))
    if reduction == "mean":
        return sim.mean()
    if reduction == "sum":
        return sim.sum()
    if reduction in ("none", None):
        return sim
    raise ValueError(f"Expected reduction to be one of ('mean', 'sum', 'none', None), got {reduction}")


def cosine_similarity(preds: Tensor, target: Tensor, reduction: str = "sum") -> Tensor:
    preds, target = _pair(preds, target, flatten=False)
    return _cosine_similarity_compute(preds, target, reduction)
