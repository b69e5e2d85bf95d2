"""Shared nominal-association helpers (counterpart of ``torchmetrics_tpu/functional/nominal/utils.py``).

Chi-squared with Yates' correction at one degree of freedom, the bias
corrections, NaN handling and the dropping of empty rows and columns. These
run at compute, where the dropped shapes read the host, as in the JAX
package; the accumulated state is a static ``(num_classes, num_classes)``
table.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn


def _nominal_input_validation(nan_strategy: str, nan_replace_value: Optional[float]) -> None:
    if nan_strategy not in ("replace", "drop"):
        raise ValueError(
            f"Argument `nan_strategy` is expected to be one of `['replace', 'drop']`, but got {nan_strategy}"
        )
    if nan_strategy == "replace" and not isinstance(nan_replace_value, (float, int)):
        raise ValueError(
            "Argument `nan_replace` is expected to be of a type `int` or `float` when `nan_strategy = 'replace`, "
            f"but got {nan_replace_value}"
        )


def _handle_nan_in_data(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tuple[Tensor, Tensor]:
    """Replace NaNs with a fill value or drop rows where either series is NaN."""
    preds, target = torch.as_tensor(preds).to(torch.float32), torch.as_tensor(target).to(torch.float32)
    if nan_strategy == "replace":
        return torch.nan_to_num(preds, nan=nan_replace_value), torch.nan_to_num(target, nan=nan_replace_value)
    keep = ~(preds.isnan() | target.isnan())
    return preds[keep], target[keep]


def _drop_empty_rows_and_cols(confmat: Tensor) -> Tensor:
    confmat = confmat[confmat.sum(1) != 0]
    return confmat[:, confmat.sum(0) != 0]


def _compute_expected_freqs(confmat: Tensor) -> Tensor:
    rows = confmat.sum(1)
    cols = confmat.sum(0)
    return torch.outer(rows, cols) / confmat.sum()


def _compute_chi_squared(confmat: Tensor, bias_correction: bool) -> Tensor:
    """χ² independence statistic (Yates-corrected at df=1, matching scipy)."""
    expected = _compute_expected_freqs(confmat)
    df = expected.numel() - sum(expected.shape) + expected.ndim - 1
    if df == 0:
        return torch.zeros((), device=confmat.device)
    if df == 1 and bias_correction:
        diff = expected - confmat
        direction = diff.sign()
        confmat = confmat + direction * diff.abs().clamp_max(0.5)
    return ((confmat - expected) ** 2 / expected).sum()


def _compute_phi_squared_corrected(phi_squared: Tensor, num_rows: int, num_cols: int, n: Tensor) -> Tensor:
    return (phi_squared - ((num_rows - 1) * (num_cols - 1)) / (n - 1)).clamp_min(0.0)


def _compute_rows_and_cols_corrected(num_rows: int, num_cols: int, n: Tensor) -> Tuple[Tensor, Tensor]:
    rows_c = num_rows - (num_rows - 1) ** 2 / (n - 1)
    cols_c = num_cols - (num_cols - 1) ** 2 / (n - 1)
    return rows_c, cols_c


def _unable_to_use_bias_correction_warning(metric_name: str) -> None:
    rank_zero_warn(
        f"Unable to compute {metric_name} using bias correction. Please consider to set `bias_correction=False`."
    )
