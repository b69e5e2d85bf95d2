"""Binned precision-recall curve pieces for the multiclass tower.

Counterpart of ``torchmetrics_tpu/functional/classification/precision_recall_curve.py``.
This slice ports the binned layout (``thresholds`` an int or a list): the
``(T, C, 2, 2)`` one-vs-rest confusion counts. The exact layout
(``thresholds=None``) waits for a later slice.

The metric's update is :func:`_binned_confmat_multiclass_accumulate`, old
int32 state + one formatted batch -> new state. For a CUDA tensor it is one
call of the CUDA kernel (``csrc/binned_confmat.cu``), which bins each score
once among the sorted thresholds and suffix-sums the bins; for a CPU tensor
it is the plain PyTorch version, :func:`_binned_confmat_multiclass_accumulate_plain`.
:func:`_binned_confmat_multiclass` gives one batch's float32 counts, as the
JAX function does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels.binned_confmat import binned_confmat_multiclass
from torchmetrics_tpu_torch.utilities.compute import normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.data import one_hot


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
