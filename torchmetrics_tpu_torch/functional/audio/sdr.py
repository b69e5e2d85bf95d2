"""SDR family (counterpart of ``torchmetrics_tpu/functional/audio/sdr.py``).

BSS-eval SDR projects ``preds`` onto ``filter_length`` shifts of ``target``:
the FFT autocorrelation ``r_0`` and cross-correlation ``b`` stay
``torch.fft`` (cuFFT on the card), as JAX leaves them to XLA; the symmetric
Toeplitz system ``toeplitz(r_0) x = b``, the coherence ``b . x`` and the log
ratio are one launch of the ``sdr_toeplitz`` CUDA kernel on the card
(``kernels/sdr_toeplitz.py``: a Schur-type recursion in float64, no matrix);
the CPU, and an input that requires grad, take its plain version, JAX's
float32 build and ``solve`` (a silent target row gives NaN there, as in
JAX). An empty batch returns an empty result before any FFT. ``use_cg_iter`` is accepted and ignored, as in JAX.

SI-SDR and SA-SDR are one launch of the ``snr_moments`` kernel
(``functional.audio.snr._ratio_db``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio
    >>> preds = torch.tensor([3.0, -0.5, 2.0, 7.0])
    >>> target = torch.tensor([3.0, -0.5, 2.0, 8.0])
    >>> round(float(scale_invariant_signal_distortion_ratio(preds, target)), 4)
    25.5862
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.audio.snr import _as_signals, _on_kernel, _ratio_db
from torchmetrics_tpu_torch.functional.image.helper import _check_same_shape
from torchmetrics_tpu_torch.kernels.sdr_toeplitz import _sdr_toeplitz_plain, sdr_toeplitz


def _compute_autocorr_crosscorr(target: Tensor, preds: Tensor, corr_len: int) -> Tuple[Tensor, Tensor]:
    """The target's autocorrelation and its cross-correlation with ``preds`` by FFT, the first ``corr_len`` lags."""
    n_fft = 2 ** math.ceil(math.log2(preds.shape[-1] + target.shape[-1] - 1))
    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    r_0 = torch.fft.irfft(t_fft.real**2 + t_fft.imag**2, n=n_fft, dim=-1)[..., :corr_len]
    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    b = torch.fft.irfft(torch.conj(t_fft) * p_fft, n=n_fft, dim=-1)[..., :corr_len]
    return r_0, b


def _sdr_from_correlations(r_0: Tensor, b: Tensor) -> Tensor:
    """SDR of each row of ``r_0`` and ``b`` ``(..., L)``: one ``sdr_toeplitz`` launch on the card, its plain
    version elsewhere."""
    if _on_kernel(r_0, b):
        rows = (-1, r_0.shape[-1])
        sdr, _ = sdr_toeplitz(r_0.reshape(rows).contiguous(), b.reshape(rows).contiguous())
        return sdr.reshape(r_0.shape[:-1])
    sdr, _ = _sdr_toeplitz_plain(r_0, b)
    return sdr


def signal_distortion_ratio(
    preds: Any,
    target: Any,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> Tensor:
    """SDR in float32, over the last axis."""
    preds, target = (x.to(torch.float32) for x in _as_signals(preds, target))
    _check_same_shape(preds, target)
    if math.prod(preds.shape[:-1]) == 0:  # no rows: the FFTs refuse an empty batch
        return torch.empty(preds.shape[:-1], dtype=torch.float32, device=preds.device)
    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)
    target = target / torch.clamp_min(torch.linalg.vector_norm(target, dim=-1, keepdim=True), 1e-6)
    preds = preds / torch.clamp_min(torch.linalg.vector_norm(preds, dim=-1, keepdim=True), 1e-6)

    r_0, b = _compute_autocorr_crosscorr(target, preds, corr_len=filter_length)
    if load_diag is not None:
        r_0 = torch.cat([r_0[..., :1] + load_diag, r_0[..., 1:]], dim=-1)  # in float32, as JAX adds it
    return _sdr_from_correlations(r_0, b)


def scale_invariant_signal_distortion_ratio(preds: Any, target: Any, zero_mean: bool = False) -> Tensor:
    """SI-SDR over the last axis."""
    preds, target = _as_signals(preds, target)
    _check_same_shape(preds, target)
    return _ratio_db(preds, target, True, zero_mean)


def source_aggregated_signal_distortion_ratio(
    preds: Any,
    target: Any,
    scale_invariant: bool = True,
    zero_mean: bool = False,
) -> Tensor:
    """SA-SDR over ``(..., spk, time)``: the energies summed over the speakers before the ratio."""
    preds, target = _as_signals(preds, target)
    _check_same_shape(preds, target)
    if preds.ndim < 2:
        raise RuntimeError(f"The preds and target should have the shape (..., spk, time), but {tuple(preds.shape)} "
                           "found")
    return _ratio_db(preds, target, scale_invariant, zero_mean, speakers=preds.shape[-2])
