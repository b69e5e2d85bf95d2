"""Short-Time Objective Intelligibility (counterpart of ``torchmetrics_tpu/functional/audio/stoi.py``).

The JAX package computes STOI on the host in numpy float64; here every step
is a torch float64 operation on the input's device: resampling to 10 kHz by
the port's own polyphase FIR (``scipy.signal.resample_poly``'s filter, padding
and output length; the taps come from ``scipy.signal.firwin``, the filtering
runs on the device), silent-frame removal (frames 40 dB below the loudest)
and overlap-add, one clip at a time since the kept lengths differ, the
256/128 STFT at 512 points, 15 one-third-octave bands from 150 Hz (a numpy
constant), 30-frame segments, and the classic (clipped, -15 dB bound) or the
extended (row- and column-normalized) correlation. A clip with too few
non-silent frames scores 1e-5 with JAX's warning.

Example::

    >>> import numpy as np
    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility
    >>> rng = np.random.default_rng(0)
    >>> target = torch.tensor(rng.normal(size=16000).astype(np.float32))
    >>> round(float(short_time_objective_intelligibility(target, target, fs=16000)), 4)  # identity -> 1
    1.0
"""

from __future__ import annotations

import functools
import math
from typing import Any, Tuple

import numpy as np
import torch
import torch.nn.functional as F  # noqa: N812
from torch import Tensor

from torchmetrics_tpu_torch.utilities.data import input_device
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

FS = 10000          # working sample rate
N_FRAME = 256       # window length
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N = 30              # segment length in frames
BETA = -15.0        # lower SDR bound
DYN_RANGE = 40      # silent-frame dynamic range


@functools.lru_cache(maxsize=4)
def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: int) -> Tuple[np.ndarray, np.ndarray]:
    """One-third octave band matrix (pystoi.utils.thirdoct)."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    freq_low = min_freq * 2.0 ** ((2 * k - 1) / 6.0)
    freq_high = min_freq * 2.0 ** ((2 * k + 1) / 6.0)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        fl_ii = np.argmin(np.square(f - freq_low[i]))
        fh_ii = np.argmin(np.square(f - freq_high[i]))
        obm[i, fl_ii:fh_ii] = 1
    return obm, cf


@functools.lru_cache(maxsize=16)
def _hann(size: int, device: torch.device) -> Tensor:
    """``np.hanning(size + 2)[1:-1]`` (no zero at either end) in float64 on ``device``, made once."""
    return torch.as_tensor(np.hanning(size + 2)[1:-1], dtype=torch.float64, device=device)


@functools.lru_cache(maxsize=16)
def _band_matrix(device: torch.device) -> Tensor:
    """The one-third octave band matrix's transpose ``(F, J)`` in float64 on ``device``, made once."""
    return torch.as_tensor(_thirdoct(FS, NFFT, NUMBAND, MINFREQ)[0].T, dtype=torch.float64, device=device)


@functools.lru_cache(maxsize=16)
def _polyphase(up: int, down: int, n_in: int, device: torch.device) -> Tuple[Tensor, Tensor, int, int]:
    """``resample_poly(x, up, down)`` of ``n_in`` samples as a gather: output m is
    ``sum_q x[index[m, q]] taps[m, q]`` over ``x`` padded by ``left`` zeros before and ``right`` after.

    The filter is scipy's (``firwin(2 * 10 max(up, down) + 1, 1 / max(up, down), window=("kaiser", 5.0)) *
    up``, ``down - half_len % down`` zeros before it); outputs ``n_pre_remove`` to ``n_pre_remove + n_out`` of
    the upsampled, filtered and downsampled signal are kept, as ``upfirdn`` and the slice give them.
    """
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0)) * up
    n_pre_pad = down - half_len % down
    h = np.concatenate([np.zeros(n_pre_pad), h])
    n_out = -(-n_in * up // down)
    n_pre_remove = (half_len + n_pre_pad) // down
    q_taps = -(-len(h) // up)
    h = np.concatenate([h, np.zeros(q_taps * up + up - len(h))])
    m = np.arange(n_pre_remove, n_pre_remove + n_out)
    j0 = m * down // up
    phase = m * down - j0 * up
    q = np.arange(q_taps)
    index = j0[:, None] - q[None, :] + q_taps  # into x padded by q_taps zeros before
    taps = h[phase[:, None] + up * q[None, :]]
    right = max(0, int(j0.max()) + 1 - n_in) if n_out else 0
    return (torch.as_tensor(index, dtype=torch.int64, device=device),
            torch.as_tensor(taps, dtype=torch.float64, device=device), q_taps, right)


def _resample(x: Tensor, fs_in: int, fs_out: int) -> Tensor:
    """``scipy.signal.resample_poly`` of the rows of ``x`` (float64) from ``fs_in`` to ``fs_out``, on its device."""
    g = math.gcd(int(fs_in), int(fs_out))
    up, down = fs_out // g, fs_in // g
    if up == down:
        return x
    index, taps, left, right = _polyphase(up, down, x.shape[-1], x.device)
    return (F.pad(x, (left, right))[..., index] * taps).sum(dim=-1)


def _overlap_add(frames: Tensor, hop: int) -> Tensor:
    """Frames ``(K, 2 hop)`` added at steps of ``hop``: each sample is the sum of at most two frames."""
    n_kept = frames.shape[0]
    if n_kept == 0:
        return frames.new_zeros(0)
    out = frames.new_zeros((n_kept + 1) * hop)
    out[: n_kept * hop] += frames[:, :hop].reshape(-1)
    out[hop:] += frames[:, hop:].reshape(-1)
    return out


def _remove_silent_frames(x: Tensor, y: Tensor, dyn_range: float, framelen: int, hop: int) -> Tuple[Tensor, Tensor]:
    """Drop the frames of both signals where ``x``'s energy is ``dyn_range`` below its loudest, overlap-add the rest."""
    if (x.shape[-1] - framelen) // hop + 1 <= 0:
        return x, y
    w = _hann(framelen, x.device)
    x_frames = x.unfold(-1, framelen, hop) * w
    y_frames = y.unfold(-1, framelen, hop) * w
    energies = 20 * torch.log10(torch.linalg.vector_norm(x_frames, dim=1) + 1e-16)
    mask = (torch.max(energies) - dyn_range - energies) < 0
    return _overlap_add(x_frames[mask], hop), _overlap_add(y_frames[mask], hop)


def _stft_mag(x: Tensor, framelen: int, hop: int, nfft: int) -> Tensor:
    """``|rfft|`` of the Hann-windowed frames ``(T, F)``."""
    frames = x.unfold(-1, framelen, hop) * _hann(framelen, x.device)
    return torch.fft.rfft(frames, n=nfft, dim=-1).abs()


def _stoi_single(x: Tensor, y: Tensor, extended: bool) -> Tensor:
    """STOI of one pair of 10 kHz float64 signals (target ``x``, estimate ``y``) as a float64 scalar."""
    x, y = _remove_silent_frames(x, y, DYN_RANGE, N_FRAME, N_FRAME // 2)
    if x.shape[-1] < N_FRAME:
        # as pystoi: a warning and a floor value, not NaN, so one clip cannot poison a running average
        rank_zero_warn("Not enough non-silent frames to compute intermediate intelligibility measure.")
        return x.new_tensor(1e-5)

    obm_t = _band_matrix(x.device)  # (F, J)
    x_tob = torch.sqrt(_stft_mag(x, N_FRAME, N_FRAME // 2, NFFT) ** 2 @ obm_t).T  # (J, T)
    y_tob = torch.sqrt(_stft_mag(y, N_FRAME, N_FRAME // 2, NFFT) ** 2 @ obm_t).T

    m = x_tob.shape[1] - N + 1
    if m <= 0:
        rank_zero_warn("Signal too short to compute intermediate intelligibility measure.")
        return x.new_tensor(1e-5)
    x_seg = x_tob.unfold(1, N, 1).permute(1, 0, 2)  # (M, J, N)
    y_seg = y_tob.unfold(1, N, 1).permute(1, 0, 2)

    def norm(v: Tensor, dim: int) -> Tensor:
        return torch.linalg.vector_norm(v, dim=dim, keepdim=True)

    if extended:
        x_n = x_seg - x_seg.mean(dim=2, keepdim=True)
        x_n = x_n / (norm(x_n, 2) + 1e-16)
        y_n = y_seg - y_seg.mean(dim=2, keepdim=True)
        y_n = y_n / (norm(y_n, 2) + 1e-16)
        x_n = x_n - x_n.mean(dim=1, keepdim=True)
        x_n = x_n / (norm(x_n, 1) + 1e-16)
        y_n = y_n - y_n.mean(dim=1, keepdim=True)
        y_n = y_n / (norm(y_n, 1) + 1e-16)
        corr = (x_n * y_n).sum(dim=1)  # (M, N) summed over bands
        return corr.sum() / (m * N)

    # classic: y normalized to x's energy and clipped, per (segment, band)
    y_norm = y_seg * (norm(x_seg, 2) / (norm(y_seg, 2) + 1e-16))
    clip_val = 10 ** (-BETA / 20)
    y_prime = torch.minimum(y_norm, x_seg * (1 + clip_val))
    xm = x_seg - x_seg.mean(dim=2, keepdim=True)
    ym = y_prime - y_prime.mean(dim=2, keepdim=True)
    corr = (xm * ym).sum(dim=2) / (norm(xm, 2)[..., 0] * norm(ym, 2)[..., 0] + 1e-16)
    return corr.mean()


def short_time_objective_intelligibility(
    preds: Any, target: Any, fs: int, extended: bool = False, keep_same_device: bool = False
) -> Tensor:
    """STOI of each signal over the last axis, float32 on the input's device."""
    device = input_device(preds)
    preds = torch.as_tensor(preds, device=device).to(torch.float64)
    target = torch.as_tensor(target, device=device).to(torch.float64)
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {tuple(preds.shape)} and "
            f"{tuple(target.shape)}."
        )
    shape = preds.shape
    if len(shape) > 1 and math.prod(shape[:-1]) == 0:  # no signals: nothing to stack
        return torch.empty(shape[:-1], dtype=torch.float32, device=device)
    flat_p = _resample(preds.reshape(-1, shape[-1]), fs, FS)
    flat_t = _resample(target.reshape(-1, shape[-1]), fs, FS)
    vals = [_stoi_single(t, p, extended) for p, t in zip(flat_p, flat_t)]
    out = torch.stack(vals).to(torch.float32).reshape(shape[:-1] or (1,))
    return out[0] if len(shape) == 1 else out
