"""PSNR and PSNR-B (counterpart of ``torchmetrics_tpu/functional/image/psnr.py``).

The float32 sums and the blocking-effect arithmetic (``n_hb`` and the rest
as Python floats) are the JAX package's.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.image.psnr import peak_signal_noise_ratio
    >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
    >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
    >>> round(float(peak_signal_noise_ratio(preds, target, data_range=4.0)), 4)
    5.0515
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helper import _check_same_shape
from torchmetrics_tpu_torch.parallel.sync import reduce
from torchmetrics_tpu_torch.utilities.data import input_device, to_tensor


def _psnr_update(preds: Tensor, target: Tensor,
                 dim: Optional[Union[int, Tuple[int, ...]]] = None) -> Tuple[Tensor, Tensor]:
    """(sum squared error, observation count), optionally per ``dim``."""
    if dim is None:
        sum_squared_error = torch.sum(torch.square(preds - target))
        return sum_squared_error, torch.tensor(float(target.numel()), dtype=torch.float32, device=target.device)
    diff = preds - target
    sum_squared_error = torch.sum(diff * diff, dim=dim)
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    count = float(np.prod([target.shape[d] for d in dim_list]))
    return sum_squared_error, torch.full_like(sum_squared_error, count, dtype=torch.float32)


def _psnr_compute(sum_squared_error: Tensor, num_obs: Tensor, data_range: Tensor, base: float = 10.0,
                  reduction: Optional[str] = "elementwise_mean") -> Tensor:
    data_range = torch.as_tensor(data_range, device=sum_squared_error.device)
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / num_obs)
    return reduce(psnr_base_e * (10 / math.log(base)), reduction or "none")


def peak_signal_noise_ratio(
    preds: Tensor,
    target: Tensor,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tensor:
    """PSNR."""
    device = input_device(preds)
    preds, target = to_tensor(preds, device), to_tensor(target, device)
    _check_same_shape(preds, target)
    if dim is None and reduction != "elementwise_mean":
        from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        rng = target.max() - target.min()
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        rng = torch.tensor(float(data_range[1] - data_range[0]), device=device)
    else:
        rng = torch.tensor(float(data_range), device=device)
    sum_squared_error, num_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, num_obs, rng, base=base, reduction=reduction)


def _compute_bef(x: Tensor, block_size: int = 8) -> Tensor:
    """Blocking effect factor of a grayscale batch (B, 1, H, W)."""
    _, channels, height, width = x.shape
    if channels > 1:
        raise ValueError(f"`psnrb` metric expects grayscale images, but got images with {channels} channels.")

    def _idx(values) -> Tensor:
        return torch.as_tensor(np.asarray(values, dtype=np.int64), device=x.device)

    h = np.arange(width - 1)
    h_b = np.arange(block_size - 1, width - 1, block_size)
    h_bc = np.asarray(sorted(set(h.tolist()) - set(h_b.tolist())), dtype=np.int64)
    v = np.arange(height - 1)
    v_b = np.arange(block_size - 1, height - 1, block_size)
    v_bc = np.asarray(sorted(set(v.tolist()) - set(v_b.tolist())), dtype=np.int64)

    d_b = torch.square(x[:, :, :, _idx(h_b)] - x[:, :, :, _idx(h_b + 1)]).sum()
    d_bc = torch.square(x[:, :, :, _idx(h_bc)] - x[:, :, :, _idx(h_bc + 1)]).sum()
    d_b = d_b + torch.square(x[:, :, _idx(v_b), :] - x[:, :, _idx(v_b + 1), :]).sum()
    d_bc = d_bc + torch.square(x[:, :, _idx(v_bc), :] - x[:, :, _idx(v_bc + 1), :]).sum()

    n_hb = height * (width / block_size) - 1
    n_hbc = (height * (width - 1)) - n_hb
    n_vb = width * (height / block_size) - 1
    n_vbc = (width * (height - 1)) - n_vb
    d_b = d_b / (n_hb + n_vb)
    d_bc = d_bc / (n_hbc + n_vbc)
    t = math.log2(block_size) / math.log2(min(height, width))
    return torch.where(d_b > d_bc, t * (d_b - d_bc), 0.0)


def _psnrb_update(preds: Tensor, target: Tensor, block_size: int = 8) -> Tuple[Tensor, Tensor, Tensor]:
    sum_squared_error = torch.sum(torch.square(preds - target))
    num_obs = torch.tensor(float(target.numel()), dtype=torch.float32, device=target.device)
    return sum_squared_error, _compute_bef(preds, block_size=block_size), num_obs


def _psnrb_compute(sum_squared_error: Tensor, bef: Tensor, num_obs: Tensor, data_range: Tensor) -> Tensor:
    mse_bef = sum_squared_error / num_obs + bef
    return torch.where(data_range > 2, 10 * torch.log10(data_range**2 / mse_bef), 10 * torch.log10(1.0 / mse_bef))


def peak_signal_noise_ratio_with_blocked_effect(preds: Tensor, target: Tensor, block_size: int = 8) -> Tensor:
    """PSNR-B."""
    device = input_device(preds)
    preds, target = to_tensor(preds, device), to_tensor(target, device)
    _check_same_shape(preds, target)
    data_range = target.max() - target.min()
    sum_squared_error, bef, num_obs = _psnrb_update(preds, target, block_size=block_size)
    return _psnrb_compute(sum_squared_error, bef, num_obs, data_range)
