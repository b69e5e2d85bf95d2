"""Shared image helpers: gaussian and uniform windows, padding, depthwise convolution
(counterpart of ``torchmetrics_tpu/functional/image/helper.py``).

The JAX package's ``lax.conv_general_dilated`` with ``feature_group_count``
becomes ``F.conv2d`` / ``F.conv3d`` with ``groups``; both are
cross-correlations, as the JAX convolution is. Torch has no edge-repeating
(``numpy`` "symmetric") pad mode, so :func:`_symmetric_pad_2d` gathers by
index.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.image.helper import _symmetric_pad_2d
    >>> _symmetric_pad_2d(torch.arange(3.0).reshape(1, 1, 1, 3), 2)[0, 0, 2].tolist()
    [1.0, 0.0, 0.0, 1.0, 2.0, 2.0]
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype = torch.float32, device=None) -> Tensor:
    """1-D gaussian window, normalized."""
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1.0, dtype=dtype, device=device)
    gauss = torch.exp(-torch.square(dist / sigma) / 2)
    return gauss / gauss.sum()


def _gaussian_kernel_2d(channel: int, kernel_size: Sequence[int], sigma: Sequence[float],
                        dtype: torch.dtype = torch.float32, device=None) -> Tensor:
    """(C, 1, kh, kw) separable gaussian, the outer product of the two 1-D windows."""
    kx = _gaussian(kernel_size[0], sigma[0], dtype, device)
    ky = _gaussian(kernel_size[1], sigma[1], dtype, device)
    return torch.outer(kx, ky).expand(channel, 1, kernel_size[0], kernel_size[1])


def _gaussian_kernel_3d(channel: int, kernel_size: Sequence[int], sigma: Sequence[float],
                        dtype: torch.dtype = torch.float32, device=None) -> Tensor:
    k2d = _gaussian_kernel_2d(1, kernel_size[:2], sigma[:2], dtype, device)[0, 0]
    kz = _gaussian(kernel_size[2], sigma[2], dtype, device)
    kernel = k2d[:, :, None] * kz[None, None, :]
    return kernel.expand(channel, 1, *kernel.shape)


@contextmanager
def _full_precision(kernel: Tensor):
    """The convolution in full float32, as the JAX package's: cuDNN with TF32 off, and on the CPU,
    for windows of at most 3 x 3, ATen's own convolution instead of oneDNN's (whose 3 x 3 path put
    SCC with a 3 x 3 window 1.4e-4 from a float64 evaluation where XLA's is 1.3e-5; larger windows
    keep oneDNN, 5-10x faster than ATen's there, and agree with XLA to float32's rounding)."""
    cudnn, mkldnn = torch.backends.cudnn, torch.backends.mkldnn
    onednn = mkldnn.enabled
    mkldnn.enabled = onednn and max(kernel.shape[2:]) > 3
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        mkldnn.enabled = onednn


def _depthwise_conv2d(x: Tensor, kernel: Tensor) -> Tensor:
    """VALID depthwise convolution; x (B, C, H, W), kernel (C, 1, kh, kw)."""
    with _full_precision(kernel):
        return F.conv2d(x, kernel.to(x.dtype), groups=x.shape[1])


def _depthwise_conv3d(x: Tensor, kernel: Tensor) -> Tensor:
    with _full_precision(kernel):
        return F.conv3d(x, kernel.to(x.dtype), groups=x.shape[1])


def _conv2d(x: Tensor, kernel: Tensor) -> Tensor:
    """Plain VALID convolution; kernel (O, I, kh, kw)."""
    with _full_precision(kernel):
        return F.conv2d(x, kernel.to(x.dtype))


def _reflect_pad_2d(x: Tensor, pad_h: int, pad_w: int) -> Tensor:
    """Mirror padding without edge repeat (``numpy`` "reflect")."""
    return F.pad(x, (pad_w, pad_w, pad_h, pad_h), mode="reflect")


def _reflect_pad_3d(x: Tensor, pad_d: int, pad_w: int, pad_h: int) -> Tensor:
    """The JAX package's order: dims 2, 3, 4 padded by ``pad_h``, ``pad_w``, ``pad_d``."""
    return F.pad(x, (pad_d, pad_d, pad_w, pad_w, pad_h, pad_h), mode="reflect")


def _symmetric_index(n: int, left: int, right: int, device) -> Tensor:
    """Source index of each padded position under ``numpy``'s "symmetric" mode (the edge repeated)."""
    m = torch.remainder(torch.arange(-left, n + right, device=device), 2 * n)
    return torch.where(m < n, m, 2 * n - 1 - m)


def _symmetric_pad_2d(x: Tensor, pad: int, outer_pad: int = 0) -> Tensor:
    """Edge-repeating pad of the last two dims: left/top ``pad``, right/bottom ``pad + outer_pad - 1``."""
    right = pad + outer_pad - 1
    rows = _symmetric_index(x.shape[-2], pad, right, x.device)
    cols = _symmetric_index(x.shape[-1], pad, right, x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


def _uniform_filter(x: Tensor, window_size: int) -> Tensor:
    """Same-size local mean with symmetric padding."""
    x = _symmetric_pad_2d(x, window_size // 2, window_size % 2)
    kernel = torch.ones((x.shape[1], 1, window_size, window_size), dtype=x.dtype, device=x.device) / (window_size**2)
    return _depthwise_conv2d(x, kernel)


def _avg_pool2d(x: Tensor) -> Tensor:
    """2 x 2 average pool, stride 2, the odd edge dropped."""
    return F.avg_pool2d(x, 2)


def _avg_pool3d(x: Tensor) -> Tensor:
    return F.avg_pool3d(x, 2)


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    if preds.shape != target.shape:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape, "
            f"but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )


def _resolve_data_range(preds: Tensor, target: Tensor, data_range) -> Tuple[Tensor, Tensor, Tensor]:
    """None: the larger span (max - min) of the two; a tuple: clamp both to it and take its span."""
    if data_range is None:
        rng = torch.maximum(preds.max() - preds.min(), target.max() - target.min())
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        rng = torch.tensor(data_range[1] - data_range[0], dtype=preds.dtype, device=preds.device)
    else:
        rng = torch.tensor(data_range, dtype=preds.dtype, device=preds.device)
    return preds, target, rng
