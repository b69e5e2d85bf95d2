"""Pairwise matrices ``x (N, d)`` against ``y (M, d)`` → ``(N, M)`` (counterpart of
``torchmetrics_tpu/functional/pairwise/pairwise.py``).

Cosine, linear and Euclidean are one matrix product each, ``torch.matmul`` in
full float32 (TF32 off whatever the caller set, as the JAX package's CPU
product is). The Manhattan and Minkowski distances are one launch of the
``pairwise_lp`` CUDA kernel for tensors on the card (``kernels/pairwise.py``;
its plain version, JAX's ``(N, M, d)`` broadcast, on the CPU).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.pairwise import pairwise_manhattan_distance
    >>> x = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    >>> pairwise_manhattan_distance(x)
    tensor([[0., 2., 1.],
            [2., 0., 1.],
            [1., 1., 0.]])
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Literal, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels.pairwise import pairwise_lp_distance
from torchmetrics_tpu_torch.utilities.data import input_device


@contextlib.contextmanager
def _full_precision_matmul() -> Iterator[None]:
    """Float32 matrix products in full float32 inside: TF32 off, as the JAX package's are."""
    matmul = torch.backends.cuda.matmul
    allowed = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = allowed


def _matmul(a: Tensor, b: Tensor) -> Tensor:
    with _full_precision_matmul():
        return a @ b


def _as_float32(x, device: torch.device) -> Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def _check_input(x, y, zero_diagonal: Optional[bool]) -> Tuple[Tensor, Tensor, bool]:
    device = input_device(x)
    x = _as_float32(x, device)
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {tuple(x.shape)}")
    if y is not None:
        y = _as_float32(y, device)
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                f" `d` should be same as the last dimension of `x`, but got {tuple(y.shape)}"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x, y, zero_diagonal


def _reduce_distance_matrix(distmat: Tensor, reduction: Optional[Literal["mean", "sum", "none"]] = None) -> Tensor:
    if reduction == "mean":
        return distmat.mean(-1)
    if reduction == "sum":
        return distmat.sum(-1)
    if reduction in (None, "none"):
        return distmat
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")


def _maybe_zero_diagonal(distmat: Tensor, zero_diagonal: bool) -> Tensor:
    """JAX's ``distmat * (1 - eye)``: a non-finite diagonal becomes NaN, not 0."""
    if not zero_diagonal:
        return distmat
    eye = torch.eye(distmat.shape[0], distmat.shape[1], dtype=distmat.dtype, device=distmat.device)
    return distmat * (1.0 - eye)


def _row_norm(x: Tensor) -> Tensor:
    """``jnp.linalg.norm(x, axis=1, keepdims=True)``: ``sqrt(sum(x * x))``."""
    return (x * x).sum(1, keepdim=True).sqrt()


def pairwise_cosine_similarity(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[Literal["mean", "sum", "none"]] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Cosine similarity matrix: xᵢ·yⱼ / (‖xᵢ‖‖yⱼ‖), the diagonal zeroed by default when ``y`` is None."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x_norm = x / _row_norm(x).clamp_min(1e-12)
    y_norm = y / _row_norm(y).clamp_min(1e-12)
    distmat = _matmul(x_norm, y_norm.T)
    return _reduce_distance_matrix(_maybe_zero_diagonal(distmat, zero_diagonal), reduction)


def pairwise_euclidean_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[Literal["mean", "sum", "none"]] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Euclidean distance matrix by JAX's expansion ``‖x‖² + ‖y‖² - 2x·y`` (one product), clamped at 0."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x_sq = (x * x).sum(1, keepdim=True)  # (N, 1)
    y_sq = (y * y).sum(1, keepdim=True).T  # (1, M)
    sq = x_sq + y_sq - 2.0 * _matmul(x, y.T)
    distmat = sq.clamp_min(0.0).sqrt()
    return _reduce_distance_matrix(_maybe_zero_diagonal(distmat, zero_diagonal), reduction)


def pairwise_linear_similarity(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[Literal["mean", "sum", "none"]] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Dot-product similarity matrix x @ yᵀ."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    distmat = _matmul(x, y.T)
    return _reduce_distance_matrix(_maybe_zero_diagonal(distmat, zero_diagonal), reduction)


def pairwise_manhattan_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    reduction: Optional[Literal["mean", "sum", "none"]] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """L1 distance matrix Σ|xᵢ - yⱼ|: one ``pairwise_lp`` launch on the card."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    distmat = pairwise_lp_distance(x, y, 1, None)
    return _reduce_distance_matrix(_maybe_zero_diagonal(distmat, zero_diagonal), reduction)


def pairwise_minkowski_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    exponent: float = 2,
    reduction: Optional[Literal["mean", "sum", "none"]] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Minkowski distance matrix (Σ|xᵢ - yⱼ|^p)^(1/p): one ``pairwise_lp`` launch on the card.

    An ``int`` exponent is JAX's ``integer_pow`` (repeated products), a
    ``float`` one ``pow``, as ``x ** exponent`` lowers in JAX.
    """
    if not (isinstance(exponent, (int, float)) and exponent > 0):
        raise ValueError(f"Argument `exponent` must be a positive number, but got {exponent}")
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    distmat = pairwise_lp_distance(x, y, exponent, "pow")
    return _reduce_distance_matrix(_maybe_zero_diagonal(distmat, zero_diagonal), reduction)
