"""Spectral and remote-sensing image metrics: UQI, SAM, ERGAS, RASE, RMSE-SW, SCC,
D-lambda, D-s, QNR and VIF-p (counterpart of ``torchmetrics_tpu/functional/image/spectral.py``).

The JAX formulas on ``F.conv2d``; ``jax.image.resize(..., "bilinear",
antialias=False)`` in D-s becomes ``F.interpolate(mode="bilinear",
align_corners=False, antialias=False)`` (both sample at half-pixel centers).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.image.spectral import spectral_angle_mapper
    >>> preds = torch.tensor([[[[1.0]], [[0.0]]]])
    >>> target = torch.tensor([[[[0.0]], [[1.0]]]])
    >>> round(float(spectral_angle_mapper(preds, target)), 4)
    1.5708
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helper import (
    _check_same_shape,
    _conv2d,
    _depthwise_conv2d,
    _gaussian_kernel_2d,
    _reflect_pad_2d,
    _symmetric_index,
    _uniform_filter,
)
from torchmetrics_tpu_torch.parallel.sync import reduce
from torchmetrics_tpu_torch.utilities.data import input_device, to_tensor


def _crop(x: Tensor, c: int) -> Tensor:
    """``x[..., c:-c, c:-c]`` as JAX slices it: nothing is left where ``c`` is 0."""
    h, w = x.shape[-2:]
    return x[..., c:h - c, c:w - c] if c else x[..., :0, :0]


def _as_pair(preds, target) -> Tuple[Tensor, Tensor]:
    device = input_device(preds)
    return to_tensor(preds, device), to_tensor(target, device)


def _check_4d(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    if preds.dtype != target.dtype:
        target = target.to(preds.dtype)
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}.")
    return preds, target


# ----------------------------------------------------------------------- UQI
def universal_image_quality_index(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """UQI: SSIM with c1 = c2 = 0."""
    preds, target = _check_4d(*_as_pair(preds, target))
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")
    if any(s < k for s, k in zip(preds.shape[-2:], kernel_size)):
        raise ValueError(
            f"Image spatial dimensions {tuple(preds.shape[-2:])} must each be at least "
            f"the kernel size {tuple(kernel_size)}; smaller inputs have no valid "
            "(un-padded) UQI positions."
        )
    channel = preds.shape[1]
    kernel = _gaussian_kernel_2d(channel, kernel_size, sigma, preds.dtype, preds.device)
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2
    preds = _reflect_pad_2d(preds, pad_h, pad_w)
    target = _reflect_pad_2d(target, pad_h, pad_w)

    b = preds.shape[0]
    stacked = torch.cat((preds, target, preds * preds, target * target, preds * target), dim=0)
    out = _depthwise_conv2d(stacked, kernel)
    mu_p, mu_t, e_pp, e_tt, e_pt = (out[i * b:(i + 1) * b] for i in range(5))
    mu_p_sq, mu_t_sq, mu_pt = mu_p**2, mu_t**2, mu_p * mu_t
    sigma_p_sq = torch.clamp(e_pp - mu_p_sq, min=0.0)
    sigma_t_sq = torch.clamp(e_tt - mu_t_sq, min=0.0)
    sigma_pt = e_pt - mu_pt
    upper = 2 * sigma_pt
    lower = sigma_p_sq + sigma_t_sq
    eps = torch.finfo(preds.dtype).eps
    uqi_idx = ((2 * mu_pt) * upper) / ((mu_p_sq + mu_t_sq) * lower + eps)
    h, w = uqi_idx.shape[-2:]
    uqi_idx = uqi_idx[..., pad_h:h - pad_h, pad_w:w - pad_w] if pad_h and pad_w else uqi_idx[..., :0, :0]  # as JAX
    return reduce(uqi_idx, reduction or "none")


# ----------------------------------------------------------------------- SAM
def spectral_angle_mapper(preds: Tensor, target: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """Per-pixel spectral angle in radians."""
    preds, target = _check_4d(*_as_pair(preds, target))
    if preds.shape[1] <= 1:
        raise ValueError(f"Expected channel dimension of `preds` and `target` to be larger than 1. Got {preds.shape[1]}.")
    dot_product = (preds * target).sum(dim=1)
    preds_norm = torch.linalg.vector_norm(preds, dim=1)
    target_norm = torch.linalg.vector_norm(target, dim=1)
    sam_score = torch.arccos(torch.clamp(dot_product / (preds_norm * target_norm), -1, 1))
    return reduce(sam_score, reduction or "none")


# --------------------------------------------------------------------- ERGAS
def error_relative_global_dimensionless_synthesis(
    preds: Tensor, target: Tensor, ratio: float = 4, reduction: Optional[str] = "elementwise_mean"
) -> Tensor:
    """ERGAS."""
    preds, target = _check_4d(*_as_pair(preds, target))
    b, c, h, w = preds.shape
    preds_f = preds.reshape(b, c, h * w)
    target_f = target.reshape(b, c, h * w)
    diff = preds_f - target_f
    sum_squared_error = torch.sum(diff * diff, dim=2)
    rmse_per_band = torch.sqrt(sum_squared_error / (h * w))
    mean_target = torch.mean(target_f, dim=2)
    ergas_score = 100 / ratio * torch.sqrt(torch.sum((rmse_per_band / mean_target) ** 2, dim=1) / c)
    return reduce(ergas_score, reduction or "none")


# ------------------------------------------------------------------- RMSE-SW
def _rmse_sw_update(preds: Tensor, target: Tensor, window_size: int, rmse_val_sum: Optional[Tensor],
                    rmse_map: Optional[Tensor], total_images: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
    """(running rmse sum, running rmse map, image count)."""
    preds, target = _check_4d(preds, target)
    if round(window_size / 2) >= target.shape[2] or round(window_size / 2) >= target.shape[3]:
        raise ValueError(
            f"Parameter `round(window_size / 2)` is expected to be smaller than"
            f" {min(target.shape[2], target.shape[3])} but got {round(window_size / 2)}."
        )
    total = (total_images if total_images is not None else 0) + target.shape[0]
    error = _uniform_filter((target - preds) ** 2, window_size)
    _rmse_map = torch.sqrt(error)
    crop = round(window_size / 2)
    val = _crop(_rmse_map, crop).sum(dim=0).mean()
    rmse_val_sum = val if rmse_val_sum is None else rmse_val_sum + val
    new_map = _rmse_map.sum(dim=0)
    rmse_map = new_map if rmse_map is None else rmse_map + new_map
    return rmse_val_sum, rmse_map, torch.as_tensor(total, dtype=torch.float32, device=preds.device)


def _rmse_sw_compute(rmse_val_sum: Optional[Tensor], rmse_map: Tensor,
                     total_images: Tensor) -> Tuple[Optional[Tensor], Tensor]:
    rmse = rmse_val_sum / total_images if rmse_val_sum is not None else None
    return rmse, rmse_map / total_images


def root_mean_squared_error_using_sliding_window(preds: Tensor, target: Tensor, window_size: int = 8,
                                                 return_rmse_map: bool = False):
    """Sliding-window RMSE."""
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError("Argument `window_size` is expected to be a positive integer.")
    preds, target = _as_pair(preds, target)
    rmse_val_sum, rmse_map, total_images = _rmse_sw_update(preds, target, window_size, None, None, None)
    rmse, rmse_map = _rmse_sw_compute(rmse_val_sum, rmse_map, total_images)
    if return_rmse_map:
        return rmse, rmse_map
    return rmse


# ---------------------------------------------------------------------- RASE
def relative_average_spectral_error(preds: Tensor, target: Tensor, window_size: int = 8) -> Tensor:
    """RASE."""
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError("Argument `window_size` is expected to be a positive integer.")
    preds, target = _check_4d(*_as_pair(preds, target))
    _, rmse_map, total_images = _rmse_sw_update(preds, target, window_size, None, None, None)
    # the filtered target divided by window_size**2 again, as the JAX package (and its reference) has it
    target_sum = (_uniform_filter(target, window_size) / (window_size**2)).sum(dim=0)
    _, rmse_map = _rmse_sw_compute(None, rmse_map, total_images)
    target_mean = (target_sum / total_images).mean(dim=0)
    rase_map = 100 / target_mean * torch.sqrt(torch.mean(rmse_map**2, dim=0))
    crop = round(window_size / 2)
    return torch.mean(_crop(rase_map, crop))


# ----------------------------------------------------------------------- SCC
def _symmetric_reflect_pad_2d(x: Tensor, pads: Tuple[int, int, int, int]) -> Tensor:
    left, right, top, bottom = pads
    rows = _symmetric_index(x.shape[-2], top, bottom, x.device)
    cols = _symmetric_index(x.shape[-1], left, right, x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


def _signal_convolve_2d(x: Tensor, kernel: Tensor) -> Tensor:
    """True (flipped-kernel) convolution with symmetric padding."""
    kh, kw = kernel.shape[2], kernel.shape[3]
    left, right = (kw - 1) // 2, math.ceil((kw - 1) / 2)
    top, bottom = (kh - 1) // 2, math.ceil((kh - 1) / 2)
    padded = _symmetric_reflect_pad_2d(x, (left, right, top, bottom))
    return _conv2d(padded, torch.flip(kernel, dims=(2, 3)))


def _local_variance_covariance(preds: Tensor, target: Tensor, window: Tensor):
    kw = window.shape[3]
    left, right = math.ceil((kw - 1) / 2), (kw - 1) // 2
    preds = F.pad(preds, (left, right, left, right))
    target = F.pad(target, (left, right, left, right))
    mu_p = _conv2d(preds, window)
    mu_t = _conv2d(target, window)
    var_p = _conv2d(preds**2, window) - mu_p**2
    var_t = _conv2d(target**2, window) - mu_t**2
    cov = _conv2d(target * preds, window) - mu_t * mu_p
    return var_p, var_t, cov


def spatial_correlation_coefficient(preds: Tensor, target: Tensor, hp_filter: Optional[Tensor] = None,
                                    window_size: int = 8, reduction: Optional[str] = "mean") -> Tensor:
    """SCC."""
    preds, target = _as_pair(preds, target)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    if hp_filter is None:
        hp_filter = torch.tensor([[-1.0, -1.0, -1.0], [-1.0, 8.0, -1.0], [-1.0, -1.0, -1.0]])
    if reduction is None:
        reduction = "none"
    if reduction not in ("mean", "none"):
        raise ValueError(f"Expected reduction to be 'mean' or 'none', but got {reduction}")
    _check_same_shape(preds, target)
    if preds.ndim not in (3, 4):
        raise ValueError(
            "Expected `preds` and `target` to have batch of colored images with BxCxHxW shape"
            f" or batch of grayscale images of BxHxW shape. Got preds: {tuple(preds.shape)}."
        )
    if preds.ndim == 3:
        preds = preds[:, None]
        target = target[:, None]
    if window_size <= 0:
        raise ValueError(f"Expected `window_size` to be a positive integer. Got {window_size}.")
    if window_size > preds.shape[2] or window_size > preds.shape[3]:
        raise ValueError(
            f"Expected `window_size` to be less than or equal to the size of the image."
            f" Got window_size: {window_size} and image size: {preds.shape[2]}x{preds.shape[3]}."
        )
    hp = torch.as_tensor(hp_filter, dtype=preds.dtype, device=preds.device)[None, None]
    window = torch.ones((1, 1, window_size, window_size), dtype=preds.dtype, device=preds.device) / (window_size**2)
    scores = []
    for i in range(preds.shape[1]):
        p = preds[:, i:i + 1]
        t = target[:, i:i + 1]
        p_hp = _signal_convolve_2d(p, hp) * 2.0
        t_hp = _signal_convolve_2d(t, hp) * 2.0
        var_p, var_t, cov = _local_variance_covariance(p_hp, t_hp, window)
        var_p = torch.clamp(var_p, min=0.0)
        var_t = torch.clamp(var_t, min=0.0)
        den = torch.sqrt(var_t) * torch.sqrt(var_p)
        scores.append(torch.where(den == 0, 0.0, cov / torch.where(den == 0, 1.0, den)))
    scc_all = torch.cat(scores, dim=1)
    if reduction == "none":
        return scc_all
    return scc_all.mean(dim=(1, 2, 3)).mean()


# ----------------------------------------------------------------------- VIF
def _vif_filter(win_size: float, sigma: float, dtype: torch.dtype, device) -> Tensor:
    coords = torch.arange(win_size, dtype=dtype, device=device) - (win_size - 1) / 2
    g = coords**2
    g = torch.exp(-(g[None, :] + g[:, None]) / (2.0 * sigma**2))
    return g / g.sum()


def _vif_per_channel(preds: Tensor, target: Tensor, sigma_n_sq: float) -> Tensor:
    """VIF-p of one channel, (B,)."""
    dtype, device = preds.dtype, preds.device
    preds = preds[:, None]
    target = target[:, None]
    eps = torch.tensor(1e-10, dtype=dtype, device=device)
    sigma_n = torch.tensor(sigma_n_sq, dtype=dtype, device=device)
    preds_vif = torch.zeros((1,), dtype=dtype, device=device)
    target_vif = torch.zeros((1,), dtype=dtype, device=device)
    for scale in range(4):
        n = 2.0 ** (4 - scale) + 1
        kernel = _vif_filter(n, n / 5, dtype, device)[None, None]
        if scale > 0:
            target = _conv2d(target, kernel)[:, :, ::2, ::2]
            preds = _conv2d(preds, kernel)[:, :, ::2, ::2]
        mu_t = _conv2d(target, kernel)
        mu_p = _conv2d(preds, kernel)
        mu_t_sq, mu_p_sq, mu_tp = mu_t**2, mu_p**2, mu_t * mu_p
        sigma_t_sq = torch.clamp(_conv2d(target**2, kernel) - mu_t_sq, min=0.0)
        sigma_p_sq = torch.clamp(_conv2d(preds**2, kernel) - mu_p_sq, min=0.0)
        sigma_tp = _conv2d(target * preds, kernel) - mu_tp

        g = sigma_tp / (sigma_t_sq + eps)
        sigma_v_sq = sigma_p_sq - g * sigma_tp
        mask = sigma_t_sq < eps
        g = torch.where(mask, 0.0, g)
        sigma_v_sq = torch.where(mask, sigma_p_sq, sigma_v_sq)
        sigma_t_sq = torch.where(mask, 0.0, sigma_t_sq)
        mask = sigma_p_sq < eps
        g = torch.where(mask, 0.0, g)
        sigma_v_sq = torch.where(mask, 0.0, sigma_v_sq)
        mask = g < 0
        sigma_v_sq = torch.where(mask, sigma_p_sq, sigma_v_sq)
        g = torch.where(mask, 0.0, g)
        sigma_v_sq = torch.clamp(sigma_v_sq, min=eps)

        preds_vif = preds_vif + torch.sum(
            torch.log10(1.0 + (g**2.0) * sigma_t_sq / (sigma_v_sq + sigma_n)), dim=(1, 2, 3))
        target_vif = target_vif + torch.sum(torch.log10(1.0 + sigma_t_sq / sigma_n), dim=(1, 2, 3))
    return preds_vif / target_vif


def visual_information_fidelity(preds: Tensor, target: Tensor, sigma_n_sq: float = 2.0) -> Tensor:
    """VIF-p, the mean over the images and channels."""
    preds, target = _as_pair(preds, target)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    if preds.shape[-1] < 41 or preds.shape[-2] < 41:
        raise ValueError(f"Invalid size of preds. Expected at least 41x41, but got {preds.shape[-1]}x{preds.shape[-2]}!")
    if target.shape[-1] < 41 or target.shape[-2] < 41:
        raise ValueError(
            f"Invalid size of target. Expected at least 41x41, but got {target.shape[-1]}x{target.shape[-2]}!")
    per_channel = [_vif_per_channel(preds[:, i], target[:, i], sigma_n_sq) for i in range(preds.shape[1])]
    return torch.cat(per_channel).mean()


# ---------------------------------------------------------- D-lambda / D-s / QNR
def _band_similarity(x: Tensor) -> Tensor:
    """(L, L) UQI of every pair of bands of ``x`` (B, L, H, W), each the mean over the batch."""
    length = x.shape[1]
    m = torch.zeros((length, length), dtype=torch.float32, device=x.device)
    for k in range(length):
        num = length - (k + 1)
        if num == 0:
            continue
        stack1 = x[:, k:k + 1].repeat(num, 1, 1, 1)
        stack2 = torch.cat([x[:, r:r + 1] for r in range(k + 1, length)], dim=0)
        vals = universal_image_quality_index(stack1, stack2, reduction="none")
        m[k, k + 1:] = torch.stack([v.mean() for v in torch.chunk(vals, num)])
    return m + m.T


def spectral_distortion_index(preds: Tensor, target: Tensor, p: int = 1,
                              reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """D-lambda for pan-sharpening."""
    preds, target = _as_pair(preds, target)
    if preds.dtype != target.dtype:
        target = target.to(preds.dtype)
    if preds.ndim != 4 or target.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}.")
    if preds.shape[:2] != target.shape[:2]:
        raise ValueError(
            "Expected `preds` and `target` to have same batch and channel sizes."
            f"Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
    length = preds.shape[1]
    diff = torch.abs(_band_similarity(target) - _band_similarity(preds)) ** p
    if length == 1:
        output = diff ** (1.0 / p)
    else:
        output = (1.0 / (length * (length - 1)) * torch.sum(diff)) ** (1.0 / p)
    return reduce(output, reduction or "none")


def spatial_distortion_index(
    preds: Tensor,
    ms: Tensor,
    pan: Tensor,
    pan_lr: Optional[Tensor] = None,
    norm_order: int = 1,
    window_size: int = 7,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """D-s for pan-sharpening."""
    device = input_device(preds)
    preds, ms, pan = (to_tensor(x, device) for x in (preds, ms, pan))
    if preds.ndim != 4 or ms.ndim != 4 or pan.ndim != 4:
        raise ValueError("Expected `preds`, `ms` and `pan` to have BxCxHxW shape.")
    if not isinstance(norm_order, int) or norm_order <= 0:
        raise ValueError(f"Expected `norm_order` to be a positive integer. Got norm_order: {norm_order}.")
    if not isinstance(window_size, int) or window_size <= 0:
        raise ValueError(f"Expected `window_size` to be a positive integer. Got window_size: {window_size}.")
    if preds.shape[:2] != ms.shape[:2] or preds.shape[:2] != pan.shape[:2]:
        raise ValueError(
            "Expected `preds`, `ms` and `pan` to have the same batch and channel sizes."
            f" Got preds: {tuple(preds.shape)}, ms: {tuple(ms.shape)} and pan: {tuple(pan.shape)}."
        )
    if preds.shape[-2:] != pan.shape[-2:]:
        raise ValueError(
            "Expected `preds` and `pan` to have the same spatial size."
            f" Got preds: {tuple(preds.shape)} and pan: {tuple(pan.shape)}."
        )
    if pan_lr is not None:
        pan_lr = to_tensor(pan_lr, device)
        if pan_lr.shape != ms.shape:
            raise ValueError(
                f"Expected `pan_lr` to have the same shape as `ms`. Got pan_lr: {tuple(pan_lr.shape)} "
                f"and ms: {tuple(ms.shape)}."
            )
    ms_h, ms_w = ms.shape[-2:]
    if window_size >= ms_h or window_size >= ms_w:
        raise ValueError(
            f"Expected `window_size` to be smaller than dimension of `ms`. Got window_size: {window_size}."
        )
    if pan_lr is None:
        pan_degraded = _uniform_filter(pan, window_size=window_size)
        pan_degraded = F.interpolate(pan_degraded, size=(ms_h, ms_w), mode="bilinear", align_corners=False,
                                     antialias=False)
    else:
        pan_degraded = pan_lr
    length = preds.shape[1]
    m1 = torch.stack([universal_image_quality_index(ms[:, i:i + 1], pan_degraded[:, i:i + 1]) for i in range(length)])
    m2 = torch.stack([universal_image_quality_index(preds[:, i:i + 1], pan[:, i:i + 1]) for i in range(length)])
    diff = torch.abs(m1 - m2) ** norm_order
    return reduce(diff, reduction or "none") ** (1 / norm_order)


def quality_with_no_reference(
    preds: Tensor,
    ms: Tensor,
    pan: Tensor,
    pan_lr: Optional[Tensor] = None,
    alpha: float = 1.0,
    beta: float = 1.0,
    norm_order: int = 1,
    window_size: int = 7,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """QNR = (1 - D_lambda)^alpha (1 - D_s)^beta."""
    if not isinstance(alpha, (int, float)) or alpha < 0:
        raise ValueError(f"Expected `alpha` to be a non-negative real number. Got alpha: {alpha}.")
    if not isinstance(beta, (int, float)) or beta < 0:
        raise ValueError(f"Expected `beta` to be a non-negative real number. Got beta: {beta}.")
    d_lambda = spectral_distortion_index(preds, ms, p=norm_order, reduction=reduction)
    d_s = spatial_distortion_index(preds, ms, pan, pan_lr, norm_order, window_size, reduction)
    return (1 - d_lambda) ** alpha * (1 - d_s) ** beta
