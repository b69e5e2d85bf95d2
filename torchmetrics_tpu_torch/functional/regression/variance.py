"""Variance explained: R², explained variance, relative squared error.

Counterpart of ``torchmetrics_tpu/functional/regression/variance.py``. Each
keeps sum-reducible statistics (sums of the target, of its square and of the
squared residuals, and the row count), so merge and sync are exact sums.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.regression.variance import explained_variance, relative_squared_error
    >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
    >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
    >>> round(float(explained_variance(preds, target)), 4)
    0.9572
    >>> round(float(relative_squared_error(preds, target)), 4)
    0.0514
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.basic import _pair

_MULTIOUTPUTS = ("raw_values", "uniform_average", "variance_weighted")


def _multioutput_error(multioutput: str) -> ValueError:
    return ValueError(
        "Argument `multioutput` must be either `raw_values`, `uniform_average` or `variance_weighted`."
        f" Received {multioutput}."
    )


def _columns(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds, target = _pair(preds, target, flatten=False)
    if preds.ndim == 1:
        preds, target = preds[:, None], target[:, None]
    return preds, target


def _r2_score_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``(sum of squared residuals, sum of target, sum of squared target, n)`` per output; n float32."""
    preds, target = _columns(preds, target)
    n = torch.tensor(target.shape[0], dtype=torch.float32, device=target.device)
    return ((target - preds) ** 2).sum(dim=0), target.sum(dim=0), (target**2).sum(dim=0), n


def _r2_score_compute(
    sum_squared_residual: Tensor,
    sum_target: Tensor,
    sum_squared_target: Tensor,
    n_obs: Tensor,
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> Tensor:
    mean_target = sum_target / n_obs
    ss_tot = sum_squared_target - sum_target * mean_target
    zero = ss_tot == 0
    raw = torch.where(zero, 0.0, 1.0 - sum_squared_residual / torch.where(zero, 1.0, ss_tot))
    if multioutput == "raw_values":
        r2 = raw if raw.shape[0] > 1 else raw[0]
    elif multioutput == "uniform_average":
        r2 = raw.mean()
    elif multioutput == "variance_weighted":
        r2 = (ss_tot / ss_tot.sum() * raw).sum()
    else:
        raise _multioutput_error(multioutput)
    if adjusted:
        if not isinstance(adjusted, int) or adjusted < 0:
            raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")
        r2 = 1.0 - (1.0 - r2) * (n_obs - 1) / (n_obs - adjusted - 1)
    return r2


def r2_score(preds: Tensor, target: Tensor, adjusted: int = 0, multioutput: str = "uniform_average") -> Tensor:
    return _r2_score_compute(*_r2_score_update(preds, target), adjusted, multioutput)


def _explained_variance_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, ...]:
    """``(n, sum of err, sum of err^2, sum of target, sum of target^2)``, err = target - preds; n float32."""
    preds, target = _columns(preds, target)
    diff = target - preds
    n = torch.tensor(target.shape[0], dtype=torch.float32, device=target.device)
    return n, diff.sum(dim=0), (diff**2).sum(dim=0), target.sum(dim=0), (target**2).sum(dim=0)


def _explained_variance_compute(
    n: Tensor, sum_error: Tensor, sum_squared_error: Tensor, sum_target: Tensor, sum_squared_target: Tensor,
    multioutput: str = "uniform_average",
) -> Tensor:
    diff_avg = sum_error / n
    numerator = sum_squared_error / n - diff_avg**2
    target_avg = sum_target / n
    denominator = sum_squared_target / n - target_avg**2
    zero = denominator == 0
    raw = 1.0 - numerator / torch.where(zero, 1.0, denominator)
    raw = torch.where(zero, torch.where(numerator == 0, 1.0, 0.0), raw)
    if multioutput == "raw_values":
        return raw if raw.shape[0] > 1 else raw[0]
    if multioutput == "uniform_average":
        return raw.mean()
    if multioutput == "variance_weighted":
        return (denominator / denominator.sum() * raw).sum()
    raise _multioutput_error(multioutput)


def explained_variance(preds: Tensor, target: Tensor, multioutput: str = "uniform_average") -> Tensor:
    return _explained_variance_compute(*_explained_variance_update(preds, target), multioutput)


def _relative_squared_error_compute(
    sum_squared_residual: Tensor, sum_target: Tensor, sum_squared_target: Tensor, n: Tensor, squared: bool = True
) -> Tensor:
    """``sum((t - p)^2) / sum((t - mean t)^2)`` over every output."""
    ss_tot = sum_squared_target - sum_target * (sum_target / n)
    rse = sum_squared_residual.sum() / torch.clamp(ss_tot.sum(), min=1e-24)
    return rse if squared else torch.sqrt(rse)


def relative_squared_error(preds: Tensor, target: Tensor, squared: bool = True) -> Tensor:
    return _relative_squared_error_compute(*_r2_score_update(preds, target), squared)
