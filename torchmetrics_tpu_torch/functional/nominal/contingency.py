"""Contingency-table association statistics: Cramér's V, Tschuprow's T, Pearson's
contingency coefficient and Theil's U (counterpart of
``torchmetrics_tpu/functional/nominal/contingency.py``).

The ``(C, C)`` table (rows the target, columns the prediction) is counted by
the ``confmat_multiclass`` CUDA kernel for series on the card, in its
``"labels"`` mode (its plain version on the CPU), as int32 counts added into
a float32 table. The labels are JAX's: the argmax of a 2-D input, NaN
replaced or dropped, then XLA's saturating float32 → int32 cast (a value past
the int32 range, and ±inf after ``nan_to_num``, becomes the nearest int32).
A dropped row is sent to target ``C``, prediction 0: its flat cell ``C * C``
lies past the table, so it adds nothing and meets no real pair.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.nominal.contingency import cramers_v, theils_u
    >>> preds = torch.tensor([0, 1, 1, 2, 2, 2])
    >>> target = torch.tensor([0, 1, 1, 2, 2, 1])
    >>> round(float(cramers_v(preds, target)), 4)
    0.7328
    >>> round(float(theils_u(preds, target)), 4)
    0.6853
"""

from __future__ import annotations

import math
from typing import Any, Literal, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import _multiclass_confmat_accumulate
from torchmetrics_tpu_torch.functional.nominal.utils import (
    _compute_chi_squared,
    _compute_phi_squared_corrected,
    _compute_rows_and_cols_corrected,
    _drop_empty_rows_and_cols,
    _nominal_input_validation,
    _unable_to_use_bias_correction_warning,
)
from torchmetrics_tpu_torch.kernels.confmat import _argmax_first
from torchmetrics_tpu_torch.utilities.data import input_device, to_tensor

NanStrategy = Literal["replace", "drop"]
_INT32_MIN, _INT32_MAX = -(2**31), 2**31 - 1
_BELOW_2_31 = 2**31 - 128  # the largest float32 below 2**31


def _series(x: Any, device: torch.device) -> Tensor:
    """A categorical series as JAX takes it: 64-bit types narrowed, the argmax of a 2-D input, float32."""
    x = to_tensor(x, device)
    if x.ndim == 2:
        x = _argmax_first(x) if x.is_floating_point() else x.argmax(1)
    return x.to(torch.float32)


def _saturating_int32(x: Tensor) -> Tensor:
    """XLA's float32 → int32 convert: toward zero, saturating at the int32 range, NaN to 0
    (torch's cast of a value past the range is undefined)."""
    inside = torch.nan_to_num(x, nan=0.0).clamp(_INT32_MIN, _BELOW_2_31).to(torch.int32)
    return torch.where(x >= 2**31, torch.full_like(inside, _INT32_MAX), inside)


def _nominal_confmat_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    nan_strategy: NanStrategy = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Categorical series → float32 (C, C) contingency table (rows=target, cols=preds)."""
    device = input_device(preds)
    preds, target = _series(preds, device), _series(target, device)
    nan_mask = preds.isnan() | target.isnan()
    fill = nan_replace_value if nan_strategy == "replace" else 0.0
    preds = _saturating_int32(torch.nan_to_num(preds, nan=fill))
    target = _saturating_int32(torch.nan_to_num(target, nan=fill))
    if nan_strategy == "drop":  # flat cell C * C: past the table, dropped by the pair rule
        target = torch.where(nan_mask, torch.full_like(target, num_classes), target)
        preds = torch.where(nan_mask, torch.zeros_like(preds), preds)
    counts = torch.zeros((num_classes, num_classes), dtype=torch.int32, device=device)
    return _multiclass_confmat_accumulate(counts, preds, target, None).to(torch.float32)


def _infer_num_classes(preds: Tensor, target: Tensor, nan_replace_value: Optional[float]) -> int:
    """Max dense label over both (cleaned) series + 1; argmax-reduces 2D inputs first."""
    device = input_device(preds)
    fill = 0.0 if nan_replace_value is None else nan_replace_value
    hi = max(float(torch.nan_to_num(_series(x, device), nan=fill).max()) for x in (preds, target))
    return int(hi) + 1


def _cramers_v_compute(confmat: Tensor, bias_correction: bool) -> Tensor:
    confmat = _drop_empty_rows_and_cols(confmat)
    n = confmat.sum()
    phi_squared = _compute_chi_squared(confmat, bias_correction) / n
    num_rows, num_cols = confmat.shape
    if bias_correction:
        phi_c = _compute_phi_squared_corrected(phi_squared, num_rows, num_cols, n)
        rows_c, cols_c = _compute_rows_and_cols_corrected(num_rows, num_cols, n)
        if float(torch.minimum(rows_c, cols_c)) == 1:
            _unable_to_use_bias_correction_warning("Cramer's V")
            return torch.tensor(math.nan, device=confmat.device)
        value = torch.sqrt(phi_c / torch.minimum(rows_c - 1, cols_c - 1))
    else:
        value = torch.sqrt(phi_squared / min(num_rows - 1, num_cols - 1))
    return value.clamp(0.0, 1.0)


def cramers_v(
    preds: Tensor,
    target: Tensor,
    bias_correction: bool = True,
    nan_strategy: NanStrategy = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Cramér's V association between two categorical series, in [0, 1]."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    num_classes = _infer_num_classes(preds, target, nan_replace_value)
    confmat = _nominal_confmat_update(preds, target, num_classes, nan_strategy, nan_replace_value)
    return _cramers_v_compute(confmat, bias_correction)


def _tschuprows_t_compute(confmat: Tensor, bias_correction: bool) -> Tensor:
    confmat = _drop_empty_rows_and_cols(confmat)
    n = confmat.sum()
    phi_squared = _compute_chi_squared(confmat, bias_correction) / n
    num_rows, num_cols = confmat.shape
    if bias_correction:
        phi_c = _compute_phi_squared_corrected(phi_squared, num_rows, num_cols, n)
        rows_c, cols_c = _compute_rows_and_cols_corrected(num_rows, num_cols, n)
        if float(torch.minimum(rows_c, cols_c)) == 1:
            _unable_to_use_bias_correction_warning("Tschuprow's T")
            return torch.tensor(math.nan, device=confmat.device)
        value = torch.sqrt(phi_c / torch.sqrt((rows_c - 1) * (cols_c - 1)))
    else:
        dof = torch.tensor(float((num_rows - 1) * (num_cols - 1)), device=confmat.device)
        value = torch.sqrt(phi_squared / torch.sqrt(dof))
    return value.clamp(0.0, 1.0)


def tschuprows_t(
    preds: Tensor,
    target: Tensor,
    bias_correction: bool = True,
    nan_strategy: NanStrategy = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Tschuprow's T association between two categorical series, in [0, 1]."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    num_classes = _infer_num_classes(preds, target, nan_replace_value)
    confmat = _nominal_confmat_update(preds, target, num_classes, nan_strategy, nan_replace_value)
    return _tschuprows_t_compute(confmat, bias_correction)


def _pearsons_contingency_coefficient_compute(confmat: Tensor) -> Tensor:
    confmat = _drop_empty_rows_and_cols(confmat)
    n = confmat.sum()
    phi_squared = _compute_chi_squared(confmat, bias_correction=False) / n
    value = torch.sqrt(phi_squared / (1 + phi_squared))
    return value.clamp(0.0, 1.0)


def pearsons_contingency_coefficient(
    preds: Tensor,
    target: Tensor,
    nan_strategy: NanStrategy = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Pearson's contingency coefficient, in [0, 1)."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    num_classes = _infer_num_classes(preds, target, nan_replace_value)
    confmat = _nominal_confmat_update(preds, target, num_classes, nan_strategy, nan_replace_value)
    return _pearsons_contingency_coefficient_compute(confmat)


def _conditional_entropy_compute(confmat: Tensor) -> Tensor:
    """H(X|Y) from a contingency table (rows = Y)."""
    confmat = _drop_empty_rows_and_cols(confmat)
    n = confmat.sum()
    p_xy = confmat / n
    p_y = confmat.sum(1) / n
    ratio = p_y[:, None] / torch.where(p_xy > 0, p_xy, torch.ones_like(p_xy))
    return torch.where(p_xy > 0, p_xy * torch.log(ratio), torch.zeros_like(p_xy)).sum()


def _theils_u_compute(confmat: Tensor) -> Tensor:
    confmat = _drop_empty_rows_and_cols(confmat)
    s_xy = _conditional_entropy_compute(confmat)
    n = confmat.sum()
    p_x = confmat.sum(0) / n
    safe = torch.where(p_x > 0, p_x, torch.ones_like(p_x))
    s_x = -torch.where(p_x > 0, p_x * torch.log(safe), torch.zeros_like(p_x)).sum()
    if float(s_x) == 0:
        return torch.zeros((), device=confmat.device)
    return (s_x - s_xy) / s_x


def theils_u(
    preds: Tensor,
    target: Tensor,
    nan_strategy: NanStrategy = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Theil's U uncertainty coefficient U(preds|target), in [0, 1]; asymmetric."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    num_classes = _infer_num_classes(preds, target, nan_replace_value)
    confmat = _nominal_confmat_update(preds, target, num_classes, nan_strategy, nan_replace_value)
    return _theils_u_compute(confmat)


def _matrix_of(stat_fn, matrix: Tensor, symmetric: bool = True, **kwargs) -> Tensor:
    """Pairwise column-vs-column statistic matrix: symmetric statistics evaluate each
    unordered pair once and mirror it."""
    matrix = torch.as_tensor(matrix, device=input_device(matrix))
    num_vars = matrix.shape[1]
    out = torch.ones((num_vars, num_vars), device=matrix.device)
    for i in range(num_vars):
        for j in range(i + 1 if symmetric else 0, num_vars):
            if i == j:
                continue
            value = stat_fn(matrix[:, i], matrix[:, j], **kwargs)
            out[i, j] = value
            if symmetric:
                out[j, i] = value
    return out


def cramers_v_matrix(
    matrix: Tensor,
    bias_correction: bool = True,
    nan_strategy: NanStrategy = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Symmetric matrix of Cramér's V between all column pairs."""
    return _matrix_of(
        cramers_v, matrix, bias_correction=bias_correction, nan_strategy=nan_strategy, nan_replace_value=nan_replace_value
    )


def tschuprows_t_matrix(
    matrix: Tensor,
    bias_correction: bool = True,
    nan_strategy: NanStrategy = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Symmetric matrix of Tschuprow's T between all column pairs."""
    return _matrix_of(
        tschuprows_t, matrix, bias_correction=bias_correction, nan_strategy=nan_strategy, nan_replace_value=nan_replace_value
    )


def pearsons_contingency_coefficient_matrix(
    matrix: Tensor,
    nan_strategy: NanStrategy = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Symmetric matrix of Pearson's contingency coefficient between column pairs."""
    return _matrix_of(
        pearsons_contingency_coefficient, matrix, nan_strategy=nan_strategy, nan_replace_value=nan_replace_value
    )


def theils_u_matrix(
    matrix: Tensor,
    nan_strategy: NanStrategy = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Asymmetric matrix of Theil's U between all column pairs."""
    return _matrix_of(theils_u, matrix, symmetric=False, nan_strategy=nan_strategy, nan_replace_value=nan_replace_value)
