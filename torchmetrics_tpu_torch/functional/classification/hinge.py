"""Hinge loss (counterpart of ``torchmetrics_tpu/functional/classification/hinge.py``).

Plain PyTorch on any device, the JAX formulas transliterated. Multiclass
scores are ``reshape(-1, num_classes)`` of the raw tensor, as in the JAX
package (the class axis of a ``(N, C, ...)`` input is not moved), and a
target outside ``[0, num_classes)`` one-hot encodes to a row of zeros, as
``jax.nn.one_hot`` gives it (``F.one_hot`` would raise).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.hinge import binary_hinge_loss, multiclass_hinge_loss
    >>> round(float(binary_hinge_loss(torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75]), torch.tensor([0, 0, 1, 1, 1]))), 4)
    0.69
    >>> logits = torch.tensor([[2.0, 0.5, 0.1], [0.2, 2.5, 0.3]])
    >>> round(float(multiclass_hinge_loss(logits, torch.tensor([0, 1]), num_classes=3)), 4)
    0.3499
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import _as_tensors
from torchmetrics_tpu_torch.utilities.compute import normalize_logits_if_needed
from torchmetrics_tpu_torch.utilities.data import one_hot

_MODES = ("crammer-singer", "one-vs-all")


def _ignore_weights(target: Tensor, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor]:
    """float32 0/1 weights (0 where the target is ``ignore_index``) and the target with those set to 0."""
    weights = torch.ones(target.shape, dtype=torch.float32, device=target.device)
    if ignore_index is not None:
        ignored = target == ignore_index
        weights = torch.where(ignored, 0.0, weights)
        target = torch.where(ignored, 0, target)
    return weights, target


def _hinge(margin: Tensor, squared: bool) -> Tensor:
    loss = torch.clamp_min(margin, 0.0)
    return loss**2 if squared else loss


def binary_hinge_loss(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Hinge loss for binary tasks; target in {0, 1} is mapped to {-1, 1}."""
    preds, target = _as_tensors(preds, target)
    preds = preds.reshape(-1).to(torch.float32)
    weights, target = _ignore_weights(target.reshape(-1), ignore_index)
    preds = normalize_logits_if_needed(preds, "sigmoid")
    t = 2.0 * target.to(torch.float32) - 1.0
    loss = _hinge(1.0 - t * preds, squared)
    return (loss * weights).sum() / torch.clamp_min(weights.sum(), 1.0)


def multiclass_hinge_loss(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Crammer-Singer hinge loss (a scalar) or one-vs-all per-class hinge losses ``(C,)``."""
    if validate_args and multiclass_mode not in _MODES:
        raise ValueError(
            f"Expected argument `multiclass_mode` to be one of ('crammer-singer', 'one-vs-all'), got {multiclass_mode}"
        )
    preds, target = _as_tensors(preds, target)
    preds = preds.to(torch.float32).reshape(-1, num_classes)
    weights, target = _ignore_weights(target.reshape(-1), ignore_index)
    preds = normalize_logits_if_needed(preds, "softmax")
    onehot = one_hot(target, num_classes, torch.float32)
    denom = torch.clamp_min(weights.sum(), 1.0)
    if multiclass_mode == "crammer-singer":
        target_score = (preds * onehot).sum(-1)
        best_other = (preds - onehot * 1e9).amax(-1) if preds.shape[0] else target_score
        loss = _hinge(1.0 - (target_score - best_other), squared)
        return (loss * weights).sum() / denom
    loss = _hinge(1.0 - (2.0 * onehot - 1.0) * preds, squared)
    return (loss * weights[:, None]).sum(0) / denom


def hinge_loss(
    preds: Tensor,
    target: Tensor,
    task: str,
    num_classes: Optional[int] = None,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    task = str(task)
    if task == "binary":
        return binary_hinge_loss(preds, target, squared, ignore_index, validate_args)
    if task == "multiclass":
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.`")
        return multiclass_hinge_loss(preds, target, num_classes, squared, multiclass_mode, ignore_index, validate_args)
    raise ValueError(f"Unsupported task `{task}` passed to `hinge_loss` (multilabel is not supported).")
