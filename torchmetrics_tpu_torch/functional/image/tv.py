"""Total variation and image gradients (counterpart of ``torchmetrics_tpu/functional/image/tv.py``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.image.tv import total_variation
    >>> round(float(total_variation(torch.arange(16.0).reshape(1, 1, 4, 4))), 4)
    60.0
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import Tensor

from torchmetrics_tpu_torch.utilities.data import input_device, to_tensor


def _total_variation_update(img: Tensor) -> Tuple[Tensor, int]:
    if img.ndim != 4:
        raise RuntimeError(f"Expected input `img` to be an 4D tensor, but got {tuple(img.shape)}")
    diff1 = img[..., 1:, :] - img[..., :-1, :]
    diff2 = img[..., :, 1:] - img[..., :, :-1]
    res1 = torch.abs(diff1).sum(dim=(1, 2, 3))
    res2 = torch.abs(diff2).sum(dim=(1, 2, 3))
    return res1 + res2, img.shape[0]


def _total_variation_compute(score: Tensor, num_elements: Union[int, Tensor], reduction: Optional[str]) -> Tensor:
    if reduction == "mean":
        return score.sum() / num_elements
    if reduction == "sum":
        return score.sum()
    if reduction is None or reduction == "none":
        return score
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")


def total_variation(img: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """The sum of absolute differences of neighbouring pixels, per image, reduced."""
    score, num_elements = _total_variation_update(to_tensor(img, input_device(img)))
    return _total_variation_compute(score, num_elements, reduction)


def image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """(dy, dx) forward differences, zero at the far edge."""
    img = to_tensor(img, input_device(img))
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor.")
    dy = img[..., 1:, :] - img[..., :-1, :]
    dx = img[..., :, 1:] - img[..., :, :-1]
    return F.pad(dy, (0, 0, 0, 1)), F.pad(dx, (0, 1, 0, 0))
