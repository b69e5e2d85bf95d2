"""SNR family (counterpart of ``torchmetrics_tpu/functional/audio/snr.py``).

Float32 signals on the card go to the ``snr_moments`` CUDA kernel
(``kernels/snr_moments.py``), one launch a call: the moments of each row in
float64, then JAX's formulas and eps. Other dtypes, an input that requires
grad (the kernel has no backward yet) and the CPU take its plain version,
JAX's form in the inputs' dtype. A tensor keeps its dtype; an array-like is
taken as JAX takes it (float64 narrowed to float32).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.audio.snr import signal_noise_ratio, scale_invariant_signal_noise_ratio
    >>> preds = torch.tensor([3.0, -0.5, 2.0, 7.0])
    >>> target = torch.tensor([3.0, -0.5, 2.0, 8.0])
    >>> round(float(signal_noise_ratio(preds, target)), 4)
    18.879
    >>> round(float(scale_invariant_signal_noise_ratio(preds, target)), 4)
    23.5724
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helper import _check_same_shape
from torchmetrics_tpu_torch.kernels.snr_moments import _snr_moments_plain, snr_moments
from torchmetrics_tpu_torch.utilities.data import input_device, to_tensor


def _as_signals(preds: Any, target: Any) -> Tuple[Tensor, Tensor]:
    """Both inputs as tensors on ``preds``' device: a tensor as it is, an array-like as JAX takes it."""
    device = input_device(preds)
    return tuple(x.to(device) if isinstance(x, Tensor) else to_tensor(x, device) for x in (preds, target))


def _on_kernel(*xs: Tensor) -> bool:
    """Float32 tensors on the card that need no grad: the kernels' inputs."""
    return all(x.device.type == "cuda" and x.dtype == torch.float32 and not x.requires_grad for x in xs)


def _ratio_db(preds: Tensor, target: Tensor, scale_invariant: bool, zero_mean: bool,
              speakers: Optional[int] = None) -> Tensor:
    """SNR (``scale_invariant=False``) or SI-SDR of ``(..., T)`` signals, or with ``speakers`` SA-SDR of
    ``(..., speakers, T)``: one ``snr_moments`` launch on the card, its plain version elsewhere."""
    group = 1 if speakers is None else speakers
    lead = preds.shape[:-1] if speakers is None else preds.shape[:-2]
    if _on_kernel(preds, target):
        rows = (-1, preds.shape[-1])
        values = snr_moments(preds.reshape(rows).contiguous(), target.reshape(rows).contiguous(), scale_invariant,
                             zero_mean, group)
    else:
        values = _snr_moments_plain(preds, target, scale_invariant, zero_mean, group)
    return values.reshape(lead)


def signal_noise_ratio(preds: Any, target: Any, zero_mean: bool = False) -> Tensor:
    """SNR = 10 log10(||target||^2 / ||target - preds||^2) over the last axis."""
    preds, target = _as_signals(preds, target)
    _check_same_shape(preds, target)
    return _ratio_db(preds, target, False, zero_mean)


def scale_invariant_signal_noise_ratio(preds: Any, target: Any) -> Tensor:
    """SI-SNR: SI-SDR with ``zero_mean=True``."""
    preds, target = _as_signals(preds, target)
    _check_same_shape(preds, target)
    return _ratio_db(preds, target, True, True)


def complex_scale_invariant_signal_noise_ratio(preds: Any, target: Any, zero_mean: bool = False) -> Tensor:
    """C-SI-SNR of complex spectrograms ``(..., F, T, 2)`` or complex ``(..., F, T)``: SI-SDR over ``F T 2``."""
    from torchmetrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio

    preds, target = _as_signals(preds, target)
    if torch.is_complex(preds):
        preds = torch.view_as_real(preds)
    if torch.is_complex(target):
        target = torch.view_as_real(target)
    if (preds.ndim < 3 or preds.shape[-1] != 2) or (target.ndim < 3 or target.shape[-1] != 2):
        raise RuntimeError(
            "Predictions and targets are expected to have the shape (..., frequency, time, 2),"
            f" but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )
    preds = preds.reshape(*preds.shape[:-3], -1)
    target = target.reshape(*target.shape[:-3], -1)
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=zero_mean)
