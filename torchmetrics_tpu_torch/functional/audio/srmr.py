"""SRMR, the speech-to-reverberation modulation energy ratio (counterpart of
``torchmetrics_tpu/functional/audio/srmr.py``).

The JAX package computes it on the host in numpy float64; here every step is
a torch float64 operation on the input's device, batched over the signals: a
gammatone filterbank as its magnitude response on the rFFT grid (23 bands on
the ERB scale from 125 Hz to 0.9 of Nyquist, a numpy constant), each band
signal by ``irfft``, its Hilbert envelope, 256 ms Hamming frames at a 64 ms
shift, and the energy of eight log-spaced modulation bands from 4 to 128 Hz;
the ratio of the first four bands' energy to the last four's. ``fast=True``
raises, as in JAX.

Example::

    >>> import numpy as np
    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.audio.srmr import speech_reverberation_modulation_energy_ratio
    >>> t = np.linspace(0, 1, 8000, dtype=np.float32)
    >>> speech_like = np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 4 * t))
    >>> v = speech_reverberation_modulation_energy_ratio(torch.tensor(speech_like), fs=8000)
    >>> bool(v > 0)
    True
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F  # noqa: N812
from torch import Tensor

from torchmetrics_tpu_torch.utilities.data import input_device


@functools.lru_cache(maxsize=8)
def _erb_center_freqs(low_freq: float, high_freq: float, n_bands: int) -> np.ndarray:
    """Equally-spaced center frequencies on the ERB scale."""
    ear_q = 9.26449
    min_bw = 24.7
    cfs = -(ear_q * min_bw) + np.exp(
        np.arange(1, n_bands + 1)
        * (-np.log(high_freq + ear_q * min_bw) + np.log(low_freq + ear_q * min_bw))
        / n_bands
    ) * (high_freq + ear_q * min_bw)
    return cfs[::-1].copy()


def _gammatone_fft_weights(fs: int, n_samples: int, cfs: np.ndarray) -> np.ndarray:
    """(n_bands, n_freqs) gammatone magnitude response sampled on the rFFT grid."""
    ear_q = 9.26449
    min_bw = 24.7
    order = 4
    freqs = np.fft.rfftfreq(n_samples, 1.0 / fs)
    erb = ((cfs / ear_q) ** order + min_bw**order) ** (1.0 / order)
    b = 1.019 * 2 * np.pi * erb
    return (1.0 + ((2 * np.pi * (freqs[None, :] - cfs[:, None])) / b[:, None]) ** 2) ** (-order / 2)


def _modulation_band_centers(min_cf: float, max_cf: float, n_bands: int = 8) -> np.ndarray:
    """Log-spaced modulation filter centers (SRMR toolbox: 4..128 Hz default)."""
    return np.exp(np.linspace(np.log(min_cf), np.log(max_cf), n_bands))


@functools.lru_cache(maxsize=16)
def _constants(fs: int, n: int, n_bands: int, low_freq: float, min_cf: float, max_cf: float, device: torch.device):
    """The gammatone weights ``(C, F)``, the Hilbert mask, the Hamming window and the modulation bands' bins."""
    cfs = _erb_center_freqs(low_freq, fs / 2 * 0.9, n_bands)
    gt = torch.as_tensor(_gammatone_fft_weights(fs, n, cfs), dtype=torch.float64, device=device)
    h = np.zeros(n)
    if n % 2 == 0:
        h[0] = h[n // 2] = 1
        h[1 : n // 2] = 2
    else:
        h[0] = 1
        h[1 : (n + 1) // 2] = 2
    wlen = int(0.256 * fs)
    window = torch.as_tensor(np.hamming(wlen), dtype=torch.float64, device=device)
    mod_freqs = np.fft.rfftfreq(wlen, 1.0 / fs)
    centers = _modulation_band_centers(min_cf, max_cf)
    edges = np.sqrt(np.concatenate([[centers[0] ** 2 / centers[1]], centers])
                    * np.concatenate([centers, [centers[-1] ** 2 / centers[-2]]]))
    bins = []
    for k in range(8):  # each band is a contiguous run of the frame's rFFT bins
        sel = np.flatnonzero((mod_freqs >= edges[k]) & (mod_freqs < edges[k + 1]))
        bins.append((int(sel[0]), int(sel[-1]) + 1) if sel.size else (0, 0))
    return gt, torch.as_tensor(h, dtype=torch.float64, device=device), window, tuple(bins)


def speech_reverberation_modulation_energy_ratio(
    preds: Any,
    fs: int,
    n_cochlear_filters: int = 23,
    low_freq: float = 125.0,
    min_cf: float = 4.0,
    max_cf: float = 128.0,
    norm: bool = False,
    fast: bool = False,
) -> Tensor:
    """SRMR of each signal over the last axis, float32 on the input's device."""
    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if fast:
        raise NotImplementedError(
            "`fast=True` (gammatonegram approximation) is not implemented; use fast=False."
        )
    device = input_device(preds)
    preds = torch.as_tensor(preds, device=device).to(torch.float64)
    shape = preds.shape
    flat = preds.reshape(-1, shape[-1])
    n = flat.shape[-1]
    gt, hilbert, window, bins = _constants(fs, n, n_cochlear_filters, low_freq, min_cf, max_cf, device)

    spec = torch.fft.rfft(flat, dim=-1)  # (B, F)
    band_sig = torch.fft.irfft(spec[:, None, :] * gt[None, :, :], n=n, dim=-1)  # (B, C, T)
    env = torch.fft.ifft(torch.fft.fft(band_sig, dim=-1) * hilbert, dim=-1).abs()  # Hilbert envelope

    wlen, shift = int(0.256 * fs), int(0.064 * fs)
    if env.shape[-1] < wlen:  # zero-pad short signals up to one full analysis window
        env = F.pad(env, (0, wlen - env.shape[-1]))
    frames = env.unfold(-1, wlen, shift) * window  # (B, C, T', W)
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2  # (B, C, T', Fm)
    e = torch.stack([power[..., lo:hi].sum(dim=-1) for lo, hi in bins], dim=-1)  # (B, C, T', 8)
    e = e.mean(dim=2)  # over the frames: (B, C, 8)
    if norm:
        e = e / (e.sum(dim=-1, keepdim=True) + 1e-16)
    total = e.sum(dim=1)  # (B, 8) over the cochlear bands
    srmr = total[:, :4].sum(dim=-1) / (total[:, 4:].sum(dim=-1) + 1e-16)
    out = srmr.to(torch.float32).reshape(shape[:-1] or (1,))
    return out[0] if len(shape) == 1 else out
