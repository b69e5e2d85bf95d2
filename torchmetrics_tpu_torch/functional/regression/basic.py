"""Mean squared error (counterpart of ``torchmetrics_tpu/functional/regression/basic.py``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.regression.basic import mean_squared_error
    >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
    >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
    >>> round(float(mean_squared_error(preds, target)), 4)
    0.375
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.data import input_device


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {preds.shape} and {target.shape}."
        )


def _mean_squared_error_update(preds: Tensor, target: Tensor, num_outputs: int = 1) -> Tuple[Tensor, int]:
    """``(sum of squared errors, number of rows)``; float32 sums, as in the JAX package."""
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    _check_same_shape(preds, target)
    shape = (-1,) if num_outputs == 1 else (-1, num_outputs)
    preds, target = preds.reshape(shape), target.reshape(shape)
    return ((preds - target) ** 2).sum(dim=0), preds.shape[0]


def mean_squared_error(preds: Tensor, target: Tensor, squared: bool = True, num_outputs: int = 1) -> Tensor:
    device = input_device(preds)
    preds, target = torch.as_tensor(preds, device=device), torch.as_tensor(target, device=device)
    sse, n = _mean_squared_error_update(preds, target, num_outputs)
    mse = sse / n
    return mse if squared else torch.sqrt(mse)
