"""Fixed operating points (counterpart of ``torchmetrics_tpu/functional/classification/fixed_operating_point.py``).

{Precision, Recall, Sensitivity, Specificity} at a fixed {Recall, Precision,
Specificity, Sensitivity}: the curve family's points (``precision_recall_curve``
or ``roc``, exact or binned, with the port's kernels on the card), then one
host step, as in the JAX package: mask the points that meet the constraint,
take the lexicographic argmax over (objective, constraint, threshold) in
float64 numpy, and return (best objective, its threshold) with the (0, 1e6)
fallback. The curves cross to the host once a call.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.fixed_operating_point import binary_precision_at_fixed_recall
    >>> prec, thresh = binary_precision_at_fixed_recall(torch.tensor([0.1, 0.4, 0.6, 0.85]), torch.tensor([0, 1, 0, 1]),
    ...                                                  min_recall=0.5)
    >>> (round(float(prec), 4), round(float(thresh), 4))
    (1.0, 0.85)
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    binary_precision_recall_curve,
    multiclass_precision_recall_curve,
    multilabel_precision_recall_curve,
)
from torchmetrics_tpu_torch.functional.classification.roc import binary_roc, multiclass_roc, multilabel_roc

Curve = Union[Tensor, List[Tensor]]


def _host_rows(x: Curve) -> List[np.ndarray]:
    """The rows of a ``(K, P)`` tensor, or the tensors of a list, as float64 numpy, in one transfer."""
    if isinstance(x, Tensor):
        return list(x.detach().to("cpu", torch.float64).numpy().reshape(x.shape[0] if x.ndim > 1 else 1, -1))
    flat = torch.cat([v.reshape(-1) for v in x]).detach().to("cpu", torch.float64).numpy()
    return np.split(flat, np.cumsum([v.numel() for v in x])[:-1])


def _lexargmax(x: np.ndarray) -> int:
    """Index of the lexicographic maximum row."""
    idx = np.arange(x.shape[0])
    for col in range(x.shape[1]):
        mx = x[idx, col].max()
        idx = idx[x[idx, col] == mx]
        if len(idx) == 1:
            break
    return int(idx[0])


def _best_host(obj: np.ndarray, con: np.ndarray, thr: np.ndarray, min_constraint: float,
               zero_sentinel: bool) -> Tuple[float, float]:
    n = min(len(obj), len(con), len(thr))
    zipped = np.stack([obj[:n], con[:n], thr[:n]], axis=1)
    masked = zipped[zipped[:, 1] >= min_constraint]
    if masked.shape[0] == 0:
        return 0.0, 1e6
    best = masked[_lexargmax(masked)]
    best_obj, best_thr = float(best[0]), float(best[2])
    if zero_sentinel and best_obj == 0.0:
        best_thr = 1e6
    return best_obj, best_thr


def _best_at_constraint(
    objective: Tensor,
    constraint: Tensor,
    thresholds: Tensor,
    min_constraint: float,
    zero_sentinel: bool = True,
) -> Tuple[Tensor, Tensor]:
    """(max objective s.t. constraint >= min, its threshold), float32 on the objective's device.

    ``zero_sentinel``: the precision-recall family returns the 1e6 sentinel
    threshold whenever the best objective is 0; the ROC family keeps the real
    threshold and gives 1e6 only when no point meets the constraint.
    """
    rows = [_host_rows(x)[0] for x in (objective.reshape(-1), constraint.reshape(-1), thresholds.reshape(-1))]
    best_obj, best_thr = _best_host(*rows, min_constraint, zero_sentinel)
    return (torch.tensor(best_obj, dtype=torch.float32, device=objective.device),
            torch.tensor(best_thr, dtype=torch.float32, device=objective.device))


def _per_class(values: Curve, constraint_values: Curve, thresholds: Curve, min_constraint: float, n: int,
               zero_sentinel: bool = True) -> Tuple[Tensor, Tensor]:
    """``_best_at_constraint`` of each of the ``n`` curves, stacked: ``(n,)`` each."""
    device = values.device if isinstance(values, Tensor) else values[0].device
    obj, con = _host_rows(values), _host_rows(constraint_values)
    thr = _host_rows(thresholds) if isinstance(thresholds, list) else _host_rows(thresholds.reshape(-1)) * n
    best = np.asarray([_best_host(obj[c], con[c], thr[c], min_constraint, zero_sentinel) for c in range(n)])
    best = torch.as_tensor(best.reshape(n, 2), dtype=torch.float32).to(device)
    return best[:, 0], best[:, 1]


def _complement(x: Curve) -> Curve:
    """``1 - fpr``: the specificity of each point."""
    return [1 - v for v in x] if isinstance(x, list) else 1 - x


def _validate_min(name: str, value: float) -> None:
    if not isinstance(value, (int, float)) or isinstance(value, bool) or not 0 <= value <= 1:
        raise ValueError(f"Expected argument `{name}` to be a float in the [0,1] range, but got {value}")


# -------------------------------------------------------- precision @ recall
def binary_precision_at_fixed_recall(
    preds, target, min_recall: float, thresholds=None, ignore_index=None, validate_args: bool = True
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _validate_min("min_recall", min_recall)
    precision, recall, thr = binary_precision_recall_curve(preds, target, thresholds, ignore_index, validate_args)
    return _best_at_constraint(precision, recall, thr, min_recall)


def multiclass_precision_at_fixed_recall(
    preds, target, num_classes: int, min_recall: float, thresholds=None, ignore_index=None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _validate_min("min_recall", min_recall)
    precision, recall, thr = multiclass_precision_recall_curve(
        preds, target, num_classes, thresholds, ignore_index, validate_args)
    return _per_class(precision, recall, thr, min_recall, num_classes)


def multilabel_precision_at_fixed_recall(
    preds, target, num_labels: int, min_recall: float, thresholds=None, ignore_index=None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _validate_min("min_recall", min_recall)
    precision, recall, thr = multilabel_precision_recall_curve(
        preds, target, num_labels, thresholds, ignore_index, validate_args)
    return _per_class(precision, recall, thr, min_recall, num_labels)


# -------------------------------------------------------- recall @ precision
def binary_recall_at_fixed_precision(
    preds, target, min_precision: float, thresholds=None, ignore_index=None, validate_args: bool = True
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _validate_min("min_precision", min_precision)
    precision, recall, thr = binary_precision_recall_curve(preds, target, thresholds, ignore_index, validate_args)
    return _best_at_constraint(recall, precision, thr, min_precision)


def multiclass_recall_at_fixed_precision(
    preds, target, num_classes: int, min_precision: float, thresholds=None, ignore_index=None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _validate_min("min_precision", min_precision)
    precision, recall, thr = multiclass_precision_recall_curve(
        preds, target, num_classes, thresholds, ignore_index, validate_args)
    return _per_class(recall, precision, thr, min_precision, num_classes)


def multilabel_recall_at_fixed_precision(
    preds, target, num_labels: int, min_precision: float, thresholds=None, ignore_index=None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _validate_min("min_precision", min_precision)
    precision, recall, thr = multilabel_precision_recall_curve(
        preds, target, num_labels, thresholds, ignore_index, validate_args)
    return _per_class(recall, precision, thr, min_precision, num_labels)


# ------------------------------------------------- sensitivity @ specificity
def binary_sensitivity_at_specificity(
    preds, target, min_specificity: float, thresholds=None, ignore_index=None, validate_args: bool = True
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _validate_min("min_specificity", min_specificity)
    fpr, tpr, thr = binary_roc(preds, target, thresholds, ignore_index, validate_args)
    return _best_at_constraint(tpr, 1 - fpr, thr, min_specificity, zero_sentinel=False)


def multiclass_sensitivity_at_specificity(
    preds, target, num_classes: int, min_specificity: float, thresholds=None, ignore_index=None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _validate_min("min_specificity", min_specificity)
    fpr, tpr, thr = multiclass_roc(preds, target, num_classes, thresholds, ignore_index, validate_args)
    return _per_class(tpr, _complement(fpr), thr, min_specificity, num_classes, zero_sentinel=False)


def multilabel_sensitivity_at_specificity(
    preds, target, num_labels: int, min_specificity: float, thresholds=None, ignore_index=None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _validate_min("min_specificity", min_specificity)
    fpr, tpr, thr = multilabel_roc(preds, target, num_labels, thresholds, ignore_index, validate_args)
    return _per_class(tpr, _complement(fpr), thr, min_specificity, num_labels, zero_sentinel=False)


# ------------------------------------------------- specificity @ sensitivity
def binary_specificity_at_sensitivity(
    preds, target, min_sensitivity: float, thresholds=None, ignore_index=None, validate_args: bool = True
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _validate_min("min_sensitivity", min_sensitivity)
    fpr, tpr, thr = binary_roc(preds, target, thresholds, ignore_index, validate_args)
    return _best_at_constraint(1 - fpr, tpr, thr, min_sensitivity, zero_sentinel=False)


def multiclass_specificity_at_sensitivity(
    preds, target, num_classes: int, min_sensitivity: float, thresholds=None, ignore_index=None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _validate_min("min_sensitivity", min_sensitivity)
    fpr, tpr, thr = multiclass_roc(preds, target, num_classes, thresholds, ignore_index, validate_args)
    return _per_class(_complement(fpr), tpr, thr, min_sensitivity, num_classes, zero_sentinel=False)


def multilabel_specificity_at_sensitivity(
    preds, target, num_labels: int, min_sensitivity: float, thresholds=None, ignore_index=None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    if validate_args:
        _validate_min("min_sensitivity", min_sensitivity)
    fpr, tpr, thr = multilabel_roc(preds, target, num_labels, thresholds, ignore_index, validate_args)
    return _per_class(_complement(fpr), tpr, thr, min_sensitivity, num_labels, zero_sentinel=False)


# --------------------------------------------------------- task dispatchers
def _dispatch_fixed(task, binary_fn, multiclass_fn, multilabel_fn, preds, target, min_value,
                    thresholds, num_classes, num_labels, ignore_index, validate_args):
    task = str(task)
    if task == "binary":
        return binary_fn(preds, target, min_value, thresholds, ignore_index, validate_args)
    if task == "multiclass":
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.`")
        return multiclass_fn(preds, target, num_classes, min_value, thresholds, ignore_index, validate_args)
    if task == "multilabel":
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.`")
        return multilabel_fn(preds, target, num_labels, min_value, thresholds, ignore_index, validate_args)
    raise ValueError(f"Task {task} not supported.")


def precision_at_fixed_recall(preds, target, task, min_recall: float, thresholds=None, num_classes=None,
                              num_labels=None, ignore_index=None, validate_args: bool = True):
    """Highest precision subject to recall >= min_recall (task dispatcher)."""
    return _dispatch_fixed(task, binary_precision_at_fixed_recall, multiclass_precision_at_fixed_recall,
                           multilabel_precision_at_fixed_recall, preds, target, min_recall,
                           thresholds, num_classes, num_labels, ignore_index, validate_args)


def recall_at_fixed_precision(preds, target, task, min_precision: float, thresholds=None, num_classes=None,
                              num_labels=None, ignore_index=None, validate_args: bool = True):
    """Highest recall subject to precision >= min_precision (task dispatcher)."""
    return _dispatch_fixed(task, binary_recall_at_fixed_precision, multiclass_recall_at_fixed_precision,
                           multilabel_recall_at_fixed_precision, preds, target, min_precision,
                           thresholds, num_classes, num_labels, ignore_index, validate_args)


def sensitivity_at_specificity(preds, target, task, min_specificity: float, thresholds=None, num_classes=None,
                               num_labels=None, ignore_index=None, validate_args: bool = True):
    """Highest sensitivity subject to specificity >= min_specificity (task dispatcher)."""
    return _dispatch_fixed(task, binary_sensitivity_at_specificity, multiclass_sensitivity_at_specificity,
                           multilabel_sensitivity_at_specificity, preds, target, min_specificity,
                           thresholds, num_classes, num_labels, ignore_index, validate_args)


def specificity_at_sensitivity(preds, target, task, min_sensitivity: float, thresholds=None, num_classes=None,
                               num_labels=None, ignore_index=None, validate_args: bool = True):
    """Highest specificity subject to sensitivity >= min_sensitivity (task dispatcher)."""
    return _dispatch_fixed(task, binary_specificity_at_sensitivity, multiclass_specificity_at_sensitivity,
                           multilabel_specificity_at_sensitivity, preds, target, min_sensitivity,
                           thresholds, num_classes, num_labels, ignore_index, validate_args)
