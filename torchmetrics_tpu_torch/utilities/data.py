"""Core data ops on ``torch.Tensor`` (counterpart of ``torchmetrics_tpu/utilities/data.py``)."""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import torch
from torch import Tensor

_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device to run on: the current CUDA device when ``device`` is None.

    Raises ``RuntimeError`` when no device is given and CUDA is unavailable:
    nothing moves to the CPU unless the caller asks for it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("No CUDA device is available. Pass device='cpu' to run on the CPU.")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def input_device(x: Any) -> torch.device:
    """Where a functional metric runs: on the device of its tensor input, or
    on the default device (:func:`resolve_device`) for other array-likes."""
    return x.device if isinstance(x, Tensor) else resolve_device(None)


def to_tensor(x: Any, device: Union[str, torch.device]) -> Tensor:
    """``x`` as a tensor on ``device``, with 64-bit types narrowed to 32 bits.

    The JAX package runs with x64 off, so a float64 or int64 input becomes
    float32 or int32 there; narrowing here keeps states and results in the
    same dtypes.
    """
    t = torch.as_tensor(x, device=device)
    narrow = _NARROW.get(t.dtype)
    return t if narrow is None else t.to(narrow)


def one_hot(labels: Tensor, num_classes: int, dtype: torch.dtype, axis: int = -1) -> Tensor:
    """``jax.nn.one_hot``: labels outside ``[0, num_classes)`` give a row of zeros."""
    axis = axis % (labels.ndim + 1)
    shape = [1] * (labels.ndim + 1)
    shape[axis] = num_classes
    classes = torch.arange(num_classes, device=labels.device).view(shape)
    return (labels.unsqueeze(axis) == classes).to(dtype)


def dim_zero_cat(x: Union[Tensor, Sequence[Tensor]]) -> Tensor:
    """Concatenation along the zero dimension; accepts a tensor, list or tuple of tensors."""
    if isinstance(x, (list, tuple)):
        if len(x) == 0:
            raise ValueError("No samples to concatenate")
        return torch.cat([torch.atleast_1d(xi) for xi in x], dim=0)
    return x


def to_onehot(label_tensor: Tensor, num_classes: int) -> Tensor:
    """Dense labels ``(N, ...)`` to an int32 one-hot ``(N, C, ...)``."""
    return one_hot(label_tensor, num_classes, torch.int32, axis=1)


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """int32 mask of the ``topk`` largest entries along ``dim``.

    For ``topk=1`` this is the argmax one-hot; ties go to the first index, as
    in ``jnp.argmax``.
    """
    if topk == 1:
        idx = torch.argmax(prob_tensor, dim=dim)
        return one_hot(idx, prob_tensor.shape[dim], torch.int32, axis=dim)
    _, idx = torch.topk(prob_tensor, topk, dim=dim)
    return torch.zeros_like(prob_tensor, dtype=torch.int32).scatter_(dim, idx, 1)
