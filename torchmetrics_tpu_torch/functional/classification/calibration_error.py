"""Calibration error (counterpart of ``torchmetrics_tpu/functional/classification/calibration_error.py``).

As in the JAX package the state is the binned sufficient statistics
(``conf_sum``, ``acc_sum``, ``count`` over ``n_bins + 1`` uniform bins of
[0, 1], the last holding confidences of exactly 1.0), fixed in shape and
``sum``-reduced. The state update of a CUDA tensor is one launch of the
``calibration_bins`` kernel (``csrc/calibration.cu``): the whole-tensor
softmax or sigmoid predicate, the confidences, the accuracies, the bins and
the add in one pass. On the CPU it is the plain version below, the JAX
functions transliterated.

Multiclass scores are taken as the JAX package takes them:
``reshape(-1, num_classes)`` of the raw tensor, so a ``(N, C, ...)`` input is
cut into rows of C consecutive scores in memory order and the class axis is
not moved (upstream TorchMetrics moves it).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.calibration_error import binary_calibration_error
    >>> preds = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75])
    >>> target = torch.tensor([0, 0, 1, 1, 1])
    >>> round(float(binary_calibration_error(preds, target, n_bins=2, norm="l1")), 4)
    0.29
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import _as_tensors
from torchmetrics_tpu_torch.kernels.calibration import calibration_bins
from torchmetrics_tpu_torch.kernels.confmat import _argmax_first
from torchmetrics_tpu_torch.utilities.compute import _safe_divide, normalize_logits_if_needed


def _bin_index(confidences: Tensor, n_bins: int) -> Tensor:
    """JAX's ``clip(floor(conf * n_bins).astype(int32), 0, n_bins)``: XLA casts NaN to 0 and
    +inf to INT32_MAX, so clamp before the cast (torch casts all three to INT32_MIN)."""
    scaled = torch.floor(confidences * n_bins)
    scaled = torch.nan_to_num(scaled, nan=0.0).clamp(0, n_bins)
    return scaled.to(torch.int64)


def _bin_update(confidences: Tensor, accuracies: Tensor, weights: Tensor, n_bins: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Scatter confidences and accuracies into the ``n_bins + 1`` bins (float32 sums).

    Left-closed bins, conf in ``[i/n, (i+1)/n)`` in bin i, conf == 1.0 in
    the last; a NaN confidence in bin 0, +inf in bin ``n_bins``.
    """
    bins = _bin_index(confidences, n_bins)
    zeros = torch.zeros(n_bins + 1, dtype=torch.float32, device=confidences.device)
    conf_sum = zeros.index_add(0, bins, confidences * weights)
    acc_sum = zeros.index_add(0, bins, accuracies * weights)
    count = zeros.index_add(0, bins, weights)
    return conf_sum, acc_sum, count


def _ce_compute_from_bins(conf_sum: Tensor, acc_sum: Tensor, count: Tensor, norm: str = "l1") -> Tensor:
    total = count.sum()
    prop = _safe_divide(count, total)
    avg_conf = _safe_divide(conf_sum, count)
    avg_acc = _safe_divide(acc_sum, count)
    gap = torch.abs(avg_acc - avg_conf)
    if norm == "l1":
        return (gap * prop).sum()
    if norm == "l2":
        return torch.sqrt((gap**2 * prop).sum())
    if norm == "max":
        return torch.where(count > 0, gap, 0.0).max()
    raise ValueError(f"Argument `norm` is expected to be one of ('l1', 'l2', 'max') but got {norm}")


def _binary_ce_confidences(preds: Tensor, target: Tensor, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor, Tensor]:
    """``(confidences, accuracies, weights)``: the positive-class probability, the target, the ignore mask."""
    preds = preds.reshape(-1).to(torch.float32)
    target = target.reshape(-1)
    weights = torch.ones_like(preds)
    if ignore_index is not None:
        ignored = target == ignore_index
        weights = torch.where(ignored, 0.0, weights)
        target = torch.where(ignored, 0, target)
    preds = normalize_logits_if_needed(preds, "sigmoid")
    return preds, target.to(torch.float32), weights


def _multiclass_ce_confidences(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int]
) -> Tuple[Tensor, Tensor, Tensor]:
    """``(confidences, accuracies, weights)`` of the rows ``preds.reshape(-1, num_classes)``."""
    preds = preds.to(torch.float32).reshape(-1, num_classes)
    target = target.reshape(-1)
    weights = torch.ones(target.shape, dtype=torch.float32, device=target.device)
    if ignore_index is not None:
        ignored = target == ignore_index
        weights = torch.where(ignored, 0.0, weights)
        target = torch.where(ignored, 0, target)
    preds = normalize_logits_if_needed(preds, "softmax")
    # jnp.max propagates NaN: say so rather than rely on the reduction of each device
    confidences = torch.where(preds.isnan().any(-1), float("nan"), preds.amax(-1))
    accuracies = (_argmax_first(preds) == target).to(torch.float32)  # jnp.argmax's tie and NaN rules
    return confidences, accuracies, weights


def _calibration_accumulate_plain(
    state: Tuple[Tensor, Tensor, Tensor],
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int],
    ignore_index: Optional[int],
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch ``calibration_bins``: the JAX confidences, ``_bin_update`` and the
    state add of the metric classes (float32 sums cast to the int32 leaves)."""
    conf_sum, acc_sum, count = state
    n_bins = conf_sum.shape[0] - 1
    if num_classes is None:
        conf, acc, w = _binary_ce_confidences(preds, target, ignore_index)
    else:
        conf, acc, w = _multiclass_ce_confidences(preds, target, num_classes, ignore_index)
    cs, as_, ct = _bin_update(conf, acc, w, n_bins)
    return conf_sum + cs, acc_sum + as_.to(acc_sum.dtype), count + ct.to(count.dtype)


def _calibration_accumulate(
    state: Tuple[Tensor, Tensor, Tensor],
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int],
    ignore_index: Optional[int],
) -> Tuple[Tensor, Tensor, Tensor]:
    """The new ``(conf_sum, acc_sum, count)`` after one raw batch (``num_classes=None``: binary).

    On a CUDA state it is one call of the ``calibration_bins`` kernel, which
    raises if it cannot launch; on a CPU state the plain version.
    """
    if state[0].device.type == "cpu":
        return _calibration_accumulate_plain(state, preds, target, num_classes, ignore_index)
    if preds.dtype not in (torch.float32, torch.float16, torch.bfloat16):
        preds = preds.to(torch.float32)  # as the JAX functions cast
    if target.dtype not in (torch.int32, torch.int64):
        target = target.to(torch.int32)
    return calibration_bins(*state, preds.contiguous(), target.contiguous(), num_classes, ignore_index)


def _zero_bins(n_bins: int, device: torch.device) -> Tuple[Tensor, Tensor, Tensor]:
    return (torch.zeros(n_bins + 1, dtype=torch.float32, device=device),
            torch.zeros(n_bins + 1, dtype=torch.int32, device=device),
            torch.zeros(n_bins + 1, dtype=torch.int32, device=device))


def _ce_validate(n_bins: int) -> None:
    if not (isinstance(n_bins, int) and n_bins > 0):
        raise ValueError(f"Expected argument `n_bins` to be an integer larger than 0, but got {n_bins}")


def binary_calibration_error(
    preds: Tensor,
    target: Tensor,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _ce_validate(n_bins)
    preds, target = _as_tensors(preds, target)
    state = _calibration_accumulate(_zero_bins(n_bins, preds.device), preds, target, None, ignore_index)
    return _ce_compute_from_bins(*state, norm)


def multiclass_calibration_error(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    if validate_args:
        _ce_validate(n_bins)
    preds, target = _as_tensors(preds, target)
    state = _calibration_accumulate(_zero_bins(n_bins, preds.device), preds, target, num_classes, ignore_index)
    return _ce_compute_from_bins(*state, norm)


def calibration_error(
    preds: Tensor,
    target: Tensor,
    task: str,
    n_bins: int = 15,
    norm: str = "l1",
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    task = str(task)
    if task == "binary":
        return binary_calibration_error(preds, target, n_bins, norm, ignore_index, validate_args)
    if task == "multiclass":
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.`")
        return multiclass_calibration_error(preds, target, num_classes, n_bins, norm, ignore_index, validate_args)
    raise ValueError(f"Unsupported task `{task}` passed to `calibration_error` (multilabel is not supported).")
