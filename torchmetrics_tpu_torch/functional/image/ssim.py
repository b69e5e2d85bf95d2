"""SSIM and MS-SSIM (counterpart of ``torchmetrics_tpu/functional/image/ssim.py``).

4-D ``(B, C, H, W)`` float32 inputs on a CUDA device take one launch of the
``ssim_window`` kernel (``csrc/ssim.cu``) a call: the window applied
separably, the inputs read unpadded once, the per-image mean (and the
contrast-sensitivity mean, or the full map) out. Every other input takes the
plain version, the JAX formulas on ``F.conv2d`` / ``F.conv3d``: CPU tensors,
and on the card 5-D volumes and dtypes other than float32 (an explicit
dispatch on ``ndim`` and ``dtype``). MS-SSIM takes one launch a scale, with
a 2 x 2 average pool between scales.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.image.ssim import structural_similarity_index_measure
    >>> img = torch.arange(256.0).reshape(1, 1, 16, 16) / 256.0
    >>> round(float(structural_similarity_index_measure(img, img * 0.9, data_range=1.0)), 4)
    0.9893
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helper import (
    _avg_pool2d,
    _avg_pool3d,
    _check_same_shape,
    _depthwise_conv2d,
    _depthwise_conv3d,
    _gaussian,
    _gaussian_kernel_2d,
    _gaussian_kernel_3d,
    _reflect_pad_2d,
    _reflect_pad_3d,
    _resolve_data_range,
)
from torchmetrics_tpu_torch.kernels.ssim import ssim_window
from torchmetrics_tpu_torch.parallel.sync import reduce
from torchmetrics_tpu_torch.utilities.data import input_device, to_tensor


def _ssim_check_inputs(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    if preds.dtype != target.dtype:
        target = target.to(preds.dtype)
    _check_same_shape(preds, target)
    if preds.ndim not in (4, 5):
        raise ValueError(
            f"Expected `preds` and `target` to have BxCxHxW or BxCxDxHxW shape. Got preds: {tuple(preds.shape)}."
        )
    return preds, target


def _window(preds: Tensor, gaussian_kernel: bool, sigma, kernel_size):
    """Validated ``(kernel_size, sigma, win_size)`` lists; a gaussian window's size derives from sigma."""
    is_3d = preds.ndim == 5
    if not isinstance(kernel_size, Sequence):
        kernel_size = (3 if is_3d else 2) * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = (3 if is_3d else 2) * [sigma]
    if len(kernel_size) != preds.ndim - 2 or len(kernel_size) not in (2, 3):
        raise ValueError(
            f"`kernel_size` has dimension {len(kernel_size)}, but expected to be two less than target dimensionality, "
            f"which is: {preds.ndim}"
        )
    if len(sigma) != preds.ndim - 2:
        raise ValueError(
            f"`sigma` has dimension {len(sigma)}, but expected to be two less than target dimensionality."
        )
    return kernel_size, sigma


def _ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """Per-image SSIM (and the CS mean or the full map): the kernel for 4-D float32 CUDA inputs, else plain."""
    kernel_size, sigma = _window(preds, gaussian_kernel, sigma, kernel_size)
    if return_full_image and return_contrast_sensitivity:
        raise ValueError("Arguments `return_full_image` and `return_contrast_sensitivity` are mutually exclusive.")
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    # a gaussian window's size derives from sigma; kernel_size applies to uniform windows only
    win_size = [int(3.5 * s + 0.5) * 2 + 1 for s in sigma] if gaussian_kernel else list(kernel_size)
    spatial = tuple(preds.shape[2:])
    if any(s < w for s, w in zip(spatial, win_size)):
        raise ValueError(
            f"Image spatial dimensions {spatial} must each be at least the analysis "
            f"window {tuple(win_size)} ({'derived from sigma' if gaussian_kernel else 'the kernel size'}); "
            "smaller inputs have no valid (un-padded) SSIM positions."
        )
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")
    if preds.device.type == "cuda" and preds.ndim == 4 and preds.dtype == torch.float32:
        return _ssim_update_kernel(preds, target, gaussian_kernel, sigma, win_size, data_range, k1, k2,
                                   return_full_image, return_contrast_sensitivity)
    return _ssim_update_plain(preds, target, gaussian_kernel, sigma, kernel_size, win_size, data_range, k1, k2,
                              return_full_image, return_contrast_sensitivity)


@functools.lru_cache(maxsize=64)
def _window_taps(gaussian_kernel: bool, size: int, sigma: float, device: torch.device) -> Tensor:
    """A 1-D window in double (the kernel's sums are double, csrc/ssim.cu), made once a device."""
    if gaussian_kernel:
        return _gaussian(size, sigma, torch.float64, device)
    return torch.full((size,), 1.0 / size, dtype=torch.float64, device=device)


def _ssim_update_kernel(preds, target, gaussian_kernel, sigma, win_size, data_range, k1, k2, return_full_image,
                        return_contrast_sensitivity):
    """One ``ssim_window`` launch; the data range of None is reduced on the device, a tuple clamps in the kernel."""
    clamp = None
    if data_range is None:  # on the device: the host does not wait for the data's extremes
        rng = torch.maximum(preds.max() - preds.min(), target.max() - target.min())
        consts = torch.stack([(k1 * rng) ** 2, (k2 * rng) ** 2]).to(torch.float32)
    else:  # by value, in JAX's float32 arithmetic: a copy to the device would wait for the stream
        if isinstance(data_range, tuple):
            clamp = (float(data_range[0]), float(data_range[1]))
            rng = np.float32(data_range[1] - data_range[0])
        else:
            rng = np.float32(data_range)
        consts = (float((np.float32(k1) * rng) ** 2), float((np.float32(k2) * rng) ** 2))
    taps = [_window_taps(gaussian_kernel, w, s, preds.device) for w, s in zip(win_size, sigma)]
    per_image, cs, full = ssim_window(preds.contiguous(), target.contiguous(), taps[0], taps[1], consts, clamp,
                                      return_contrast_sensitivity, return_full_image)
    if return_contrast_sensitivity:
        return per_image, cs
    if return_full_image:
        return per_image, full
    return per_image


def _ssim_update_plain(preds, target, gaussian_kernel, sigma, kernel_size, win_size, data_range, k1, k2,
                       return_full_image, return_contrast_sensitivity):
    """Plain PyTorch ``ssim_window``: the JAX formulas (pad, 5-way stack, one depthwise convolution, crop)."""
    is_3d = preds.ndim == 5
    preds, target, rng = _resolve_data_range(preds, target, data_range)
    c1 = (k1 * rng) ** 2
    c2 = (k2 * rng) ** 2
    channel = preds.shape[1]
    dtype, device = preds.dtype, preds.device
    pad_h = (win_size[0] - 1) // 2
    pad_w = (win_size[1] - 1) // 2
    uniform = torch.ones((channel, 1, *kernel_size), dtype=dtype, device=device) / torch.prod(
        torch.tensor(kernel_size, dtype=dtype, device=device))
    if is_3d:
        pad_d = (win_size[2] - 1) // 2
        preds = _reflect_pad_3d(preds, pad_d, pad_w, pad_h)
        target = _reflect_pad_3d(target, pad_d, pad_w, pad_h)
        kernel = _gaussian_kernel_3d(channel, win_size, sigma, dtype, device) if gaussian_kernel else uniform
        conv = _depthwise_conv3d
    else:
        preds = _reflect_pad_2d(preds, pad_h, pad_w)
        target = _reflect_pad_2d(target, pad_h, pad_w)
        kernel = _gaussian_kernel_2d(channel, win_size, sigma, dtype, device) if gaussian_kernel else uniform
        conv = _depthwise_conv2d

    b = preds.shape[0]
    stacked = torch.cat((preds, target, preds * preds, target * target, preds * target), dim=0)
    out = conv(stacked, kernel)
    mu_p, mu_t, e_pp, e_tt, e_pt = (out[i * b:(i + 1) * b] for i in range(5))

    mu_p_sq = mu_p**2
    mu_t_sq = mu_t**2
    mu_pt = mu_p * mu_t
    sigma_p_sq = torch.clamp(e_pp - mu_p_sq, min=0.0)
    sigma_t_sq = torch.clamp(e_tt - mu_t_sq, min=0.0)
    sigma_pt = e_pt - mu_pt

    upper = 2 * sigma_pt + c2
    lower = sigma_p_sq + sigma_t_sq + c2
    ssim_full = ((2 * mu_pt + c1) * upper) / ((mu_p_sq + mu_t_sq + c1) * lower)

    def crop(x: Tensor) -> Tensor:  # x[..., p:-p] keeps nothing where p == 0, as in JAX
        h = x.shape[2]
        x = x[:, :, pad_h:h - pad_h] if pad_h else x[:, :, :0]
        w = x.shape[3]
        x = x[:, :, :, pad_w:w - pad_w] if pad_w else x[:, :, :, :0]
        if is_3d:
            d = x.shape[4]
            x = x[..., pad_d:d - pad_d] if pad_d else x[..., :0]
        return x

    per_image = crop(ssim_full).reshape(b, -1).mean(-1)
    if return_contrast_sensitivity:
        return per_image, crop(upper / lower).reshape(b, -1).mean(-1)
    if return_full_image:
        return per_image, ssim_full
    return per_image


def structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """SSIM."""
    device = input_device(preds)
    preds, target = _ssim_check_inputs(to_tensor(preds, device), to_tensor(target, device))
    out = _ssim_update(preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
                       return_full_image, return_contrast_sensitivity)
    if isinstance(out, tuple):
        return reduce(out[0], reduction or "none"), out[1]
    return reduce(out, reduction or "none")


def _multiscale_ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Sequence[float] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> Tensor:
    """Per-image MS-SSIM: one SSIM (with CS) a scale."""
    is_3d = preds.ndim == 5
    ks = kernel_size if isinstance(kernel_size, Sequence) else (3 if is_3d else 2) * [kernel_size]
    if preds.shape[-1] < 2 ** len(betas) or preds.shape[-2] < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width dimensions must be"
            f" larger than or equal to {2 ** len(betas)}."
        )
    _betas_div = max(1, (len(betas) - 1)) ** 2
    if preds.shape[-2] // _betas_div <= ks[0] - 1 or preds.shape[-1] // _betas_div <= ks[1] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {ks[0]},"
            f" the image height/width must be larger than {(ks[0] - 1) * _betas_div}."
        )
    mcs_list: List[Tensor] = []
    sim = None
    for _ in range(len(betas)):
        sim, cs = _ssim_update(preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
                               return_contrast_sensitivity=True)
        if normalize == "relu":
            sim = torch.clamp(sim, min=0.0)
            cs = torch.clamp(cs, min=0.0)
        mcs_list.append(cs)
        preds = _avg_pool3d(preds) if is_3d else _avg_pool2d(preds)
        target = _avg_pool3d(target) if is_3d else _avg_pool2d(target)
    mcs_list[-1] = sim
    mcs_stack = torch.stack(mcs_list)
    if normalize == "simple":
        mcs_stack = (mcs_stack + 1) / 2
    betas_arr = torch.tensor(list(betas), dtype=mcs_stack.dtype, device=mcs_stack.device).reshape(-1, 1)
    return torch.prod(mcs_stack**betas_arr, dim=0)


def multiscale_structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = "relu",
) -> Tensor:
    """MS-SSIM."""
    device = input_device(preds)
    preds, target = _ssim_check_inputs(to_tensor(preds, device), to_tensor(target, device))
    if not isinstance(betas, tuple) or not all(isinstance(b, float) for b in betas):
        raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
    if normalize is not None and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
    mcs = _multiscale_ssim_update(preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, betas,
                                  normalize)
    return reduce(mcs, reduction or "none")
