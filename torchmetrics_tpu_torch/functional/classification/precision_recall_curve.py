"""Precision-recall curve pieces for the three tasks, exact and binned.

Counterpart of ``torchmetrics_tpu/functional/classification/precision_recall_curve.py``.
Two layouts, as in the JAX package:

* ``thresholds=None``, exact: :func:`_binary_clf_curve` sorts the scores
  (stable, descending), takes the cumulative true and false positives and
  collapses each tie group onto its last point with a static shape (the
  JAX package's reversed min-scan, here ``flip`` + ``cummin``). It works on
  the last dimension, so the curves of many classes or labels come out of
  one batched sort (:func:`_exact_column_curves`).
* ``thresholds`` an int or a list, binned: the ``(T, 2, 2)`` (binary) or
  ``(T, C|L, 2, 2)`` one-vs-rest or per-label confusion counts.

The metrics' binned updates fold one formatted batch into the old int32
state. For a CUDA tensor each is one call of a CUDA kernel that bins
each score once among the sorted thresholds and suffix-sums the bins:
``binned_confmat_multiclass`` (``csrc/binned_confmat.cu``,
:func:`_binned_confmat_multiclass_accumulate`) and
``binned_confmat_multilabel`` (``csrc/binned_multilabel.cu``,
:func:`_binned_confmat_multilabel_accumulate`;
the binary update, :func:`_binned_curve_accumulate`, is its case of one
label). For a CPU tensor each is its plain PyTorch version, the JAX
package's contraction form. :func:`_binned_confmat_multiclass`,
:func:`_binned_confmat_multilabel` and :func:`_binned_curve_update` give one
batch's float32 counts, as the JAX functions do.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    ...     binary_precision_recall_curve)
    >>> precision, recall, thresholds = binary_precision_recall_curve(
    ...     torch.tensor([0.1, 0.6, 0.35, 0.8]), torch.tensor([0, 1, 0, 1]))
    >>> precision
    tensor([0.5000, 0.6667, 1.0000, 1.0000, 1.0000])
    >>> recall
    tensor([1.0000, 1.0000, 1.0000, 0.5000, 0.0000])
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels.binned_confmat import binned_confmat_multiclass
from torchmetrics_tpu_torch.kernels.binned_multilabel import binned_confmat_multilabel
from torchmetrics_tpu_torch.utilities.compute import _safe_divide, normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.data import input_device, one_hot, to_tensor


def _linspace_grid(num: int) -> np.ndarray:
    """``num`` float32 thresholds from 0 to 1, bit-equal to ``jnp.linspace(0.0, 1.0, num)``.

    XLA computes ``linspace`` as ``i * (1 / (num - 1))`` in float32, with the
    last point set to the end. ``torch.linspace`` and ``np.linspace`` round
    some points differently (one point at num=20, 18 at num=200), and a score
    that falls between the two grids lands in another bin.
    """
    step = np.float32(1.0) / np.float32(num - 1)
    grid = np.arange(num, dtype=np.float32) * step
    grid[-1] = np.float32(1.0)
    return grid


def _adjust_threshold_arg(
    thresholds: Union[int, Sequence[float], Tensor, None], device: Union[str, torch.device]
) -> Optional[Tensor]:
    if thresholds is None:
        return None
    if isinstance(thresholds, int):
        return torch.from_numpy(_linspace_grid(thresholds)).to(device)
    return torch.as_tensor(thresholds, dtype=torch.float32, device=device)


def _validate_thresholds(thresholds) -> None:
    if thresholds is not None and not isinstance(thresholds, (int, list, tuple, Tensor)):
        raise ValueError(
            f"Expected argument `thresholds` to either be an integer, list of floats or tensor of floats, but got {thresholds}"
        )
    if isinstance(thresholds, int) and thresholds < 2:
        raise ValueError(f"If argument `thresholds` is an integer, expected it to be larger than 1, but got {thresholds}")


def _binary_prc_format(preds: Tensor, target: Tensor, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor, Tensor]:
    """``(probs (N,) float32, target (N,) int32, weights (N,) float32)``, flattened
    and sigmoid-normalized if any score of the batch lies outside [0, 1]."""
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    weights = torch.ones(target.shape, dtype=torch.float32, device=target.device)
    if ignore_index is not None:
        ignored = target == ignore_index
        weights = torch.where(ignored, 0.0, weights)
        target = torch.where(ignored, 0, target)
    preds = normalize_logits_if_needed(preds.to(torch.float32), "sigmoid")
    return preds, target.to(torch.int32), weights


def _multilabel_prc_format(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int]
) -> Tuple[Tensor, Tensor, Tensor]:
    """``(probs (N, L) float32, target (N, L) int32, weights (N, L) float32)``,
    sigmoid-normalized if any score of the batch lies outside [0, 1]; an
    element whose target is ``ignore_index`` gets weight 0 and target 0."""
    preds = preds.reshape(-1, num_labels)
    target = target.reshape(-1, num_labels)
    weights = torch.ones(target.shape, dtype=torch.float32, device=target.device)
    if ignore_index is not None:
        ignored = target == ignore_index
        weights = torch.where(ignored, 0.0, weights)
        target = torch.where(ignored, 0, target)
    preds = normalize_logits_if_needed(preds.to(torch.float32), "sigmoid")
    return preds, target.to(torch.int32), weights


def _multiclass_prc_format(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int]
) -> Tuple[Tensor, Tensor, Tensor]:
    """``(probs (N, C) float32, target (N,) int32, weights (N,) float32)``, softmax-normalized."""
    target = target.reshape(-1)
    # (N, C, ...) -> (N*S, C): move the class axis last before flattening so
    # spatial positions stay paired with their class scores
    if preds.ndim > 2:
        preds = torch.movedim(preds, 1, -1)
    preds = preds.reshape(-1, num_classes)
    weights = torch.ones(target.shape, dtype=torch.float32, device=target.device)
    if ignore_index is not None:
        ignored = target == ignore_index
        weights = torch.where(ignored, 0.0, weights)
        target = torch.where(ignored, 0, target)
    preds = normalize_logits_if_needed(preds.to(torch.float32), "softmax")
    return preds, target.to(torch.int32), weights


def _binary_clf_curve(preds: Tensor, target: Tensor, weights: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """Exact cumulative ``(fps, tps, thresholds)`` in descending score order, along the last dim.

    Static shape: every point of a tie group is replaced by the group's last
    point (duplicated coordinates, zero-length segments), so no curve or area
    changes. The JAX function takes one 1-D curve; leading dims here are
    independent curves.
    """
    target = target.to(torch.float32)
    w = torch.ones_like(preds, dtype=torch.float32) if weights is None else weights
    n = preds.shape[-1]
    # ascending sort of -preds, as jnp.argsort(-preds, stable=True): NaN scores go last
    _, order = torch.sort(-preds, dim=-1, stable=True)
    preds_s = torch.gather(preds, -1, order)
    target_s = torch.gather(target.expand_as(preds), -1, order)
    w_s = torch.gather(w.expand_as(preds), -1, order)
    tps = torch.cumsum(target_s * w_s, dim=-1)
    fps = torch.cumsum((1.0 - target_s) * w_s, dim=-1)
    # point i ends its tie group iff preds[i] != preds[i+1] (or i is last)
    last = torch.ones_like(preds_s[..., :1], dtype=torch.bool)
    group_end = torch.cat([preds_s[..., :-1] != preds_s[..., 1:], last], dim=-1)
    idx = torch.where(group_end, torch.arange(n, device=preds.device), n - 1)
    next_end = torch.flip(torch.cummin(torch.flip(idx, (-1,)), dim=-1).values, (-1,))
    return fps.gather(-1, next_end), tps.gather(-1, next_end), preds_s.gather(-1, next_end)


def _binary_precision_recall_curve_compute_exact(
    preds: Tensor, target: Tensor, weights: Optional[Tensor]
) -> Tuple[Tensor, Tensor, Tensor]:
    """Exact ``(precision, recall, thresholds)`` along the last dim, ascending
    thresholds, with the final (1, 0) point."""
    fps, tps, thresholds = _binary_clf_curve(preds, target, weights)
    precision = _safe_divide(tps, tps + fps)
    recall = _safe_divide(tps, tps[..., -1:])
    ones = torch.ones_like(precision[..., :1])
    precision = torch.cat([torch.flip(precision, (-1,)), ones], dim=-1)
    recall = torch.cat([torch.flip(recall, (-1,)), torch.zeros_like(ones)], dim=-1)
    return precision, recall, torch.flip(thresholds, (-1,))


def _binary_precision_recall_curve_compute_binned(confmat: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """``(precision, recall, thresholds)`` of a ``(T, ..., 2, 2)`` binned state,
    with the final (1, 0) point appended along T."""
    tp = confmat[..., 1, 1]
    fp = confmat[..., 0, 1]
    fn = confmat[..., 1, 0]
    ones = torch.ones_like(tp[:1], dtype=torch.float32)
    precision = torch.cat([_safe_divide(tp, tp + fp), ones], dim=0)
    recall = torch.cat([_safe_divide(tp, tp + fn), torch.zeros_like(ones)], dim=0)
    return precision, recall, thresholds


def _binned_curve_update(preds: Tensor, target: Tensor, weights: Tensor, thresholds: Tensor) -> Tensor:
    """``(T, 2, 2)`` float32 binary threshold-confusion counts of one batch: ``[[tn, fp], [fn, tp]]``.

    The JAX function's contract: the multilabel counts at one label.
    """
    return _binned_confmat_multilabel(preds[:, None], target[:, None], weights[:, None], thresholds)[:, 0]


def _binned_curve_accumulate(
    confmat: Tensor,
    p: Tensor,
    target: Tensor,
    w: Tensor,
    thresholds: Tensor,
    sorted_thresholds: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tensor:
    """New ``(T, 2, 2)`` int32 binary state: ``confmat`` + one formatted batch's counts.

    The multilabel update at one label: the state is viewed as
    ``(T, 1, 2, 2)`` and the ``(N,)`` batch as ``(N, 1)``, so on a CUDA
    tensor it is one call of the ``binned_confmat_multilabel`` kernel.
    """
    new = _binned_confmat_multilabel_accumulate(
        confmat.view(-1, 1, 2, 2), p[:, None], target[:, None], w[:, None], thresholds, sorted_thresholds
    )
    return new.view(-1, 2, 2)


#: elements of a (columns, rows) block that the exact curves sort at once
EXACT_BLOCK = 2**25


def _exact_column_curves(p: Tensor, target: Tensor, w: Tensor, fn=None) -> Iterator[Tuple[int, int, tuple]]:
    """Exact curves of every column of ``p (N, K)``: yields ``(lo, hi, fn(...))``
    for blocks of columns, each block sorted in one ``torch.sort``.

    ``target`` is ``(N,)`` class ids (one-vs-rest: column ``k``'s positives
    are the rows of class ``k``, all weighted by ``w (N,)``) or ``(N, K)``
    per-column labels with ``(N, K)`` weights. ``fn`` takes the block's
    ``(preds, target, weights)`` as ``(columns, N)`` rows, default
    :func:`_binary_precision_recall_curve_compute_exact`. The JAX package
    loops over the columns; every row of a block is the curve it gives.
    """
    fn = fn or _binary_precision_recall_curve_compute_exact
    n, k = p.shape
    step = max(1, EXACT_BLOCK // max(n, 1))
    for lo in range(0, k, step):
        hi = min(lo + step, k)
        if target.ndim == 1:
            cols = torch.arange(lo, hi, device=p.device)
            t, wc = (target[None, :] == cols[:, None]).to(torch.int32), w
        else:
            t, wc = target[:, lo:hi].T, w[:, lo:hi].T
        yield lo, hi, fn(p[:, lo:hi].T, t, wc)


def _column_curve_lists(p: Tensor, target: Tensor, w: Tensor, fn=None) -> Tuple[List[Tensor], ...]:
    """The exact curve of every column as per-column lists, as the JAX functions return them."""
    out: Tuple[List[Tensor], ...] = ([], [], [])
    for _, _, curves in _exact_column_curves(p, target, w, fn):
        for lst, rows in zip(out, curves):
            lst.extend(rows)
    return out


def _stack_confmat(tp: Tensor, pospred: Tensor, actpos: Tensor, total: Tensor) -> Tensor:
    """``(T, C, 2, 2)`` from the counts: ``state[t, c] = [[tn, fp], [fn, tp]]``."""
    fp = pospred - tp
    fn = actpos[None, :] - tp
    tn = total - pospred - fn
    return torch.stack([torch.stack([tn, fp], -1), torch.stack([fn, tp], -1)], -2)


def _sort_thresholds(thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """``(ascending thresholds, int32 index of each in ``thresholds``)``.

    A stable sort: equal thresholds keep their order, NaNs go last (as
    ``numpy.argsort(kind="stable")`` orders them). The kernel takes both.
    """
    values, order = torch.sort(thresholds, stable=True)
    return values, order.to(torch.int32)


def _binned_confmat_multiclass_plain(
    p: Tensor, target: Tensor, w: Tensor, thresholds: Tensor, num_classes: int
) -> Tensor:
    """Plain PyTorch ``(T, C, 2, 2)`` float32 confusion counts of one batch.

    A transcription of the JAX function: ``tp`` is one (T, N) @ (N, C)
    product against the weighted one-hot, ``pospred`` contracts an
    (N, C, T) comparison tensor with the weights. A target outside
    ``[0, C)`` has a zero one-hot row, so the row is a negative for every
    class; its true-class score is read at a clamped index and counts
    nowhere. The tests hold it equal to the JAX function, exactly.
    """
    ohw = one_hot(target, num_classes, p.dtype) * w[:, None]  # (N, C)
    s = torch.gather(p, 1, target.long().clamp(0, num_classes - 1)[:, None])[:, 0]  # (N,) true-class score
    pred_true = (s[:, None] >= thresholds[None, :]).to(p.dtype)  # (N, T)
    tp = pred_true.T @ ohw  # (T, C)
    cmp = (p[:, :, None] >= thresholds[None, None, :]).to(p.dtype)  # (N, C, T)
    pospred = torch.einsum("nct,n->tc", cmp, w)  # (T, C)
    return _stack_confmat(tp, pospred, ohw.sum(0), w.sum())


def _binned_confmat_multiclass_accumulate_plain(
    confmat: Tensor, p: Tensor, target: Tensor, w: Tensor, thresholds: Tensor, num_classes: int
) -> Tensor:
    """Plain PyTorch fused update: ``confmat`` + this batch's counts, int32.

    The counts are float32 sums of 0/1 weights, exact integers below 2**24
    rows a batch, as in the JAX package. The tests hold the new state equal
    to the JAX function's counts added to the same int32 state, exactly.
    """
    return confmat + _binned_confmat_multiclass_plain(p, target, w, thresholds, num_classes).to(torch.int32)


def _binned_confmat_multiclass_accumulate(
    confmat: Tensor,
    p: Tensor,
    target: Tensor,
    w: Tensor,
    thresholds: Tensor,
    num_classes: int,
    sorted_thresholds: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tensor:
    """New ``(T, C, 2, 2)`` int32 state: ``confmat`` + one formatted batch's counts.

    ``state[t, c] = [[tn, fp], [fn, tp]]`` in the order of ``thresholds``;
    ``confmat`` is only read. On a CUDA tensor it is one call of the
    ``binned_confmat_multiclass`` kernel, which raises if it cannot launch;
    ``sorted_thresholds`` is ``_sort_thresholds(thresholds)``, which a
    metric computes once (sorted here when not given). On a CPU tensor it is
    the plain version. The two are equal (``torch.equal``) on the card, in
    ``chip_smoke.py``.
    """
    if p.device.type == "cpu":
        return _binned_confmat_multiclass_accumulate_plain(confmat, p, target, w, thresholds, num_classes)
    if p.ndim != 2 or p.shape[1] != num_classes:
        raise ValueError(f"Expected scores for {num_classes} classes, got shape {tuple(p.shape)}")
    if sorted_thresholds is None:
        sorted_thresholds = _sort_thresholds(thresholds)
    return binned_confmat_multiclass(confmat, p.contiguous(), target.contiguous(), w.contiguous(), *sorted_thresholds)


def _binned_confmat_multiclass(
    p: Tensor, target: Tensor, w: Tensor, thresholds: Tensor, num_classes: int
) -> Tensor:
    """``(T, C, 2, 2)`` float32 one-vs-rest threshold confusion counts of one batch.

    The JAX function's contract, held equal to it exactly in the tests. On
    a CPU tensor the plain version; on a CUDA tensor the fused kernel's
    update of a zero state, cast to float32 (equal to the plain version,
    ``torch.equal``, in ``chip_smoke.py``).
    """
    if p.device.type == "cpu":
        return _binned_confmat_multiclass_plain(p, target, w, thresholds, num_classes)
    zeros = torch.zeros((thresholds.shape[0], num_classes, 2, 2), dtype=torch.int32, device=p.device)
    return _binned_confmat_multiclass_accumulate(zeros, p, target, w, thresholds, num_classes).to(p.dtype)


def _binned_confmat_multilabel_plain(p: Tensor, target: Tensor, w: Tensor, thresholds: Tensor) -> Tensor:
    """Plain PyTorch ``(T, L, 2, 2)`` float32 per-label counts of one batch.

    A transcription of the JAX function: an ``(N, L, T)`` comparison tensor
    contracted by two einsums with ``target * w`` and ``w``. The tests hold
    it equal to the JAX function, exactly.
    """
    tw = target.to(p.dtype) * w  # (N, L)
    cmp = (p[:, :, None] >= thresholds[None, None, :]).to(p.dtype)  # (N, L, T)
    tp = torch.einsum("nlt,nl->tl", cmp, tw)
    pospred = torch.einsum("nlt,nl->tl", cmp, w)
    return _stack_confmat(tp, pospred, tw.sum(0), w.sum(0))


def _binned_confmat_multilabel_accumulate_plain(
    confmat: Tensor, p: Tensor, target: Tensor, w: Tensor, thresholds: Tensor
) -> Tensor:
    """Plain PyTorch update: ``confmat`` + this batch's counts, int32, as the
    JAX metric adds them (float32 sums, exact below 2**24 a cell a batch)."""
    return confmat + _binned_confmat_multilabel_plain(p, target, w, thresholds).to(torch.int32)


def _binned_confmat_multilabel_accumulate(
    confmat: Tensor,
    p: Tensor,
    target: Tensor,
    w: Tensor,
    thresholds: Tensor,
    sorted_thresholds: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tensor:
    """New ``(T, L, 2, 2)`` int32 state: ``confmat`` + one formatted batch's counts.

    ``state[t, l] = [[tn, fp], [fn, tp]]`` in the order of ``thresholds``;
    ``confmat`` is only read. On a CUDA tensor it is one call of the
    ``binned_confmat_multilabel`` kernel, which raises if it cannot launch;
    ``sorted_thresholds`` is ``_sort_thresholds(thresholds)``, which a
    metric computes once (sorted here when not given). On a CPU tensor it is
    the plain version. The two are equal (``torch.equal``) on the card, in
    ``chip_smoke.py``.
    """
    if p.device.type == "cpu":
        return _binned_confmat_multilabel_accumulate_plain(confmat, p, target, w, thresholds)
    if sorted_thresholds is None:
        sorted_thresholds = _sort_thresholds(thresholds)
    return binned_confmat_multilabel(confmat, p.contiguous(), target.contiguous(), w.contiguous(), *sorted_thresholds)


def _binned_confmat_multilabel(p: Tensor, target: Tensor, w: Tensor, thresholds: Tensor) -> Tensor:
    """``(T, L, 2, 2)`` float32 per-label threshold confusion counts of one batch.

    The JAX function's contract: the plain version on a CPU tensor, the
    kernel's update of a zero state on a CUDA tensor.
    """
    if p.device.type == "cpu":
        return _binned_confmat_multilabel_plain(p, target, w, thresholds)
    zeros = torch.zeros((thresholds.shape[0], p.shape[1], 2, 2), dtype=torch.int32, device=p.device)
    return _binned_confmat_multilabel_accumulate(zeros, p, target, w, thresholds).to(p.dtype)


def _binned_curves(confmat: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """``(precision, recall)`` ``(K, T + 1)`` of a ``(T, K, 2, 2)`` state, with
    the final (1, 0) point, and the thresholds, as the multiclass and
    multilabel curves return them."""
    precision, recall, thresholds = _binary_precision_recall_curve_compute_binned(confmat, thresholds)
    return precision.T, recall.T, thresholds


def binary_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    if validate_args:
        _validate_thresholds(thresholds)
    device = input_device(preds)
    p, t, w = _binary_prc_format(to_tensor(preds, device), to_tensor(target, device), ignore_index)
    thr = _adjust_threshold_arg(thresholds, device)
    if thr is None:
        return _binary_precision_recall_curve_compute_exact(p, t, w)
    return _binary_precision_recall_curve_compute_binned(_binned_curve_update(p, t, w, thr), thr)


def multiclass_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Exact: per-class lists of curves; binned: ``(C, T + 1)`` precision and recall and the thresholds."""
    if validate_args:
        _validate_thresholds(thresholds)
    device = input_device(preds)
    p, t, w = _multiclass_prc_format(to_tensor(preds, device), to_tensor(target, device), num_classes, ignore_index)
    thr = _adjust_threshold_arg(thresholds, device)
    if thr is None:
        return _column_curve_lists(p, t, w)
    return _binned_curves(_binned_confmat_multiclass(p, t, w, thr, num_classes), thr)


def multilabel_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Exact: per-label lists of curves; binned: ``(L, T + 1)`` precision and recall and the thresholds."""
    if validate_args:
        _validate_thresholds(thresholds)
    device = input_device(preds)
    p, t, w = _multilabel_prc_format(to_tensor(preds, device), to_tensor(target, device), num_labels, ignore_index)
    thr = _adjust_threshold_arg(thresholds, device)
    if thr is None:
        return _column_curve_lists(p, t, w)
    return _binned_curves(_binned_confmat_multilabel(p, t, w, thr), thr)


def precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    task = str(task)
    if task == "binary":
        return binary_precision_recall_curve(preds, target, thresholds, ignore_index, validate_args)
    if task == "multiclass":
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.`")
        return multiclass_precision_recall_curve(preds, target, num_classes, thresholds, ignore_index, validate_args)
    if task == "multilabel":
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.`")
        return multilabel_precision_recall_curve(preds, target, num_labels, thresholds, ignore_index, validate_args)
    raise ValueError(f"Unsupported task `{task}` passed to `precision_recall_curve`.")
