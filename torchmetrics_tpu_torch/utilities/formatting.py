"""Flexible classification input canonicalization (counterpart of ``torchmetrics_tpu/utilities/formatting.py``).

Heterogeneous classification inputs (float probabilities or logits, or
integer labels, with or without a class dimension, with extra spatial
dims) are classified into one of four cases and canonicalized to 0/1 int32
tensors of shape ``(N, C)`` or ``(N, C, X)``, through the JAX package's
detect, validate and canonicalize steps and its rules table.

The JAX module copies both tensors to the host (numpy) to run its checks.
Here they stay on their device: the case comes from shapes and dtypes, and
the value checks read the extremes of the target (and of integer
predictions) from the device in one host read, with the JAX module's
errors.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.utilities.formatting import classify_inputs
    >>> p, t, case = classify_inputs(torch.tensor([[0.1, 0.9], [0.7, 0.3]]), torch.tensor([1, 0]))
    >>> case.value, p.tolist(), t.tolist()
    ('multi-class', [[0, 1], [1, 0]], [[0, 1], [1, 0]])
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.data import input_device, select_topk, to_onehot, to_tensor
from torchmetrics_tpu_torch.utilities.enums import DataType

__all__ = ["classify_inputs", "DataType"]

Extremes = Dict[str, int]


def _extremes(preds: Tensor, target: Tensor) -> Extremes:
    """``t_min``/``t_max`` of a non-empty target and ``p_min``/``p_max`` of non-empty
    integer predictions, read from the device in one transfer."""
    names, values = [], []
    if target.numel():
        names += ["t_min", "t_max"]
        values += [target.min(), target.max()]
    if preds.numel() and not preds.is_floating_point():
        names += ["p_min", "p_max"]
        values += [preds.min(), preds.max()]
    if not values:
        return {}
    return dict(zip(names, torch.stack([v.to(torch.int64) for v in values]).tolist()))


def _squeeze_excess(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Drop every size-1 dimension except the leading batch dim."""
    if preds.shape[:1] == (1,):
        return preds.squeeze()[None], target.squeeze()[None]
    return preds.squeeze(), target.squeeze()


def _detect_case(preds: Tensor, target: Tensor, extremes: Optional[Extremes] = None) -> Tuple[DataType, int]:
    """Classify the (preds, target) shape/dtype combination.

    Returns the case and the implied class count (``C`` dim for multi-class
    probabilities, flattened extra dims for multi-label).
    """
    floating = preds.is_floating_point()

    if preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                f"`preds` and `target` with equal rank must have equal shape; got "
                f"{tuple(preds.shape)} vs {tuple(target.shape)}."
            )
        if floating and target.numel():
            extremes = _extremes(preds, target) if extremes is None else extremes
            if extremes["t_max"] > 1:
                raise ValueError("With same-shaped float `preds`, `target` must be binary (0/1).")
        if preds.ndim == 1:
            case = DataType.BINARY if floating else DataType.MULTICLASS
        else:
            case = DataType.MULTILABEL if floating else DataType.MULTIDIM_MULTICLASS
        implied = int(preds[0].numel()) if preds.numel() else 0
        return case, implied

    if preds.ndim == target.ndim + 1:
        if not floating:
            raise ValueError("`preds` with one extra dimension must be float probabilities/logits.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "With an extra class dimension, `preds` must be (N, C, ...) and "
                "`target` (N, ...) over the same trailing dims."
            )
        implied = int(preds.shape[1]) if preds.numel() else 0
        return (DataType.MULTICLASS if preds.ndim == 2 else DataType.MULTIDIM_MULTICLASS), implied

    raise ValueError(
        "Shapes must be either identical (N, ...) for both, or (N, C, ...) `preds` "
        f"with (N, ...) `target`; got {tuple(preds.shape)} and {tuple(target.shape)}."
    )


def _validate(
    preds: Tensor,
    target: Tensor,
    case: DataType,
    implied: int,
    top_k: Optional[int],
    num_classes: Optional[int],
    multiclass: Optional[bool],
    ignore_index: Optional[int],
    extremes: Optional[Extremes] = None,
) -> None:
    """The JAX module's consistency rules, in its order and with its errors."""
    floating = preds.is_floating_point()
    ext = _extremes(preds, target) if extremes is None else extremes
    has_t, has_p = "t_min" in ext, "p_min" in ext

    # the JAX module's exact condition, including its falsy-zero quirk:
    # ignore_index=0 disables the negativity check
    if has_t and ext["t_min"] < 0 and (ignore_index is None or (ignore_index and ignore_index >= 0)):
        raise ValueError("`target` must be non-negative.")
    if has_p and ext["p_min"] < 0:
        raise ValueError("Integer `preds` must be non-negative.")
    if multiclass is False:
        if has_t and ext["t_max"] > 1:
            raise ValueError("`multiclass=False` requires `target` values <= 1.")
        if has_p and ext["p_max"] > 1:
            raise ValueError("`multiclass=False` requires integer `preds` values <= 1.")

    if preds.shape != target.shape:  # C-dim cases
        if multiclass is False and implied != 2:
            raise ValueError("`multiclass=False` needs exactly 2 classes along the C dimension of `preds`.")
        if has_t and ext["t_max"] >= implied:
            raise ValueError("The highest `target` label must be below the C dimension of `preds`.")

    if num_classes:
        if case == DataType.BINARY:
            if num_classes > 2:
                raise ValueError("Binary data cannot have `num_classes` > 2.")
            if num_classes == 2 and not multiclass:
                raise ValueError(
                    "Binary data with `num_classes=2` needs `multiclass=True` to be promoted to multi-class format."
                )
            if num_classes == 1 and multiclass:
                raise ValueError("Binary data with `multiclass=True` needs `num_classes=2` (or unset).")
        elif case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS):
            if num_classes == 1 and multiclass is not False:
                raise ValueError(
                    "`num_classes=1` on multi-class data requires `multiclass=False` "
                    "(demote two-class data to binary/multi-label)."
                )
            if num_classes > 1:
                if multiclass is False and implied != num_classes:
                    raise ValueError(
                        "`multiclass=False` demotion requires `num_classes` to match the implied class count."
                    )
                if has_t and num_classes <= ext["t_max"]:
                    raise ValueError("The highest `target` label must be below `num_classes`.")
                if has_p and num_classes <= ext["p_max"]:
                    raise ValueError("The highest `preds` label must be below `num_classes`.")
                if preds.shape != target.shape and num_classes != implied:
                    raise ValueError("`num_classes` must match the C dimension of `preds`.")
        else:  # multi-label
            if multiclass and num_classes != 2:
                raise ValueError(
                    "Promoting multi-label data with `multiclass=True` requires `num_classes` of 2 or None."
                )
            if not multiclass and num_classes != implied:
                raise ValueError("`num_classes` must match the implied label count.")

    if top_k is not None:
        if case == DataType.BINARY:
            raise ValueError("`top_k` does not apply to binary data.")
        if not isinstance(top_k, int) or top_k <= 0:
            raise ValueError("`top_k` must be a positive integer.")
        if not floating:
            raise ValueError("`top_k` needs probability `preds`, not labels.")
        if multiclass is False:
            raise ValueError("`top_k` cannot combine with `multiclass=False`.")
        if case == DataType.MULTILABEL and multiclass:
            raise ValueError("`top_k` cannot combine with multi-label promotion.")
        if top_k >= implied:
            raise ValueError("`top_k` must be strictly below the C dimension of `preds`.")


def classify_inputs(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, DataType]:
    """Auto-classify and canonicalize flexible classification inputs.

    ========================  =================  =======================
    preds                     target             case
    ========================  =================  =======================
    float (N,)                binary int (N,)    binary
    int (N,)                  int (N,)           multi-class
    float (N, C)              int (N,)           multi-class
    float (N, ...)            binary int (N,...) multi-label
    float (N, C, ...)         int (N, ...)       multi-dim multi-class
    int (N, ...)              int (N, ...)       multi-dim multi-class
    ========================  =================  =======================

    Returns int32 0/1 tensors of shape ``(N, C)`` or ``(N, C, X)`` on the
    device of ``preds``, plus the detected :class:`DataType`; ``multiclass``
    promotes or demotes between the binary and two-class representations as
    the JAX function does. Inputs become tensors as the port's metrics take
    them (64-bit types narrowed to 32 bits); float16 and bfloat16 scores are
    widened to float32 first.
    """
    device = input_device(preds)
    p, t = to_tensor(preds, device), to_tensor(target, device)

    if not (p.numel() == 0 and t.numel() == 0):
        if t.is_floating_point():
            raise ValueError("`target` must be an integer tensor.")
        if p.shape[:1] != t.shape[:1]:
            raise ValueError("`preds` and `target` must agree on the batch dimension.")

    p, t = _squeeze_excess(p, t)
    if p.dtype in (torch.float16, torch.bfloat16):
        p = p.to(torch.float32)

    extremes = _extremes(p, t)
    case, implied = _detect_case(p, t, extremes)
    if not (p.numel() == 0 and t.numel() == 0):
        _validate(p, t, case, implied, top_k, num_classes, multiclass, ignore_index, extremes)

    pj, tj = p, t
    preds_are_probs = p.is_floating_point()

    if case in (DataType.BINARY, DataType.MULTILABEL) and not top_k:
        pj = (pj >= threshold).to(torch.int32)
        preds_are_probs = False
        num_classes = 2 if multiclass else num_classes
    if case == DataType.MULTILABEL and top_k:
        pj = select_topk(pj, top_k)
        preds_are_probs = False

    if case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) or multiclass:
        if preds_are_probs:
            num_classes = p.shape[1]
            pj = select_topk(pj, top_k or 1)
        else:
            if not num_classes:
                top = max(extremes.get("p_max", 0), extremes.get("t_max", 0), 0)
                num_classes = top + 1 if p.numel() else 1
            pj = to_onehot(pj, max(2, num_classes))
        tj = to_onehot(tj, max(2, num_classes))
        if multiclass is False:
            pj, tj = pj[:, 1, ...], tj[:, 1, ...]

    if pj.numel() or tj.numel():
        promote = (case in (DataType.MULTICLASS, DataType.MULTIDIM_MULTICLASS) and multiclass is not False) or multiclass
        if promote:
            pj = pj.reshape(pj.shape[0], pj.shape[1], -1)
            tj = tj.reshape(tj.shape[0], tj.shape[1], -1)
        else:
            pj = pj.reshape(pj.shape[0], -1)
            tj = tj.reshape(tj.shape[0], -1)

    if pj.ndim > 2 and pj.shape[-1] == 1:
        pj, tj = pj.squeeze(-1), tj.squeeze(-1)

    return pj.to(torch.int32), tj.to(torch.int32), case
