"""PESQ (counterpart of ``torchmetrics_tpu/functional/audio/pesq.py``).

As in the JAX package, the score comes from the native ``pesq`` package when
it is installed, or from a ``backend`` callable ``(fs, target, preds, mode) ->
float`` the caller gives; without either the call raises
``ModuleNotFoundError``. The backend runs on the host, one signal at a time;
the scores come back as float32 on the input's device.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.audio.pesq import perceptual_evaluation_speech_quality
    >>> toy_backend = lambda fs, target, preds, mode: 4.5  # a stand-in for the native package
    >>> sig = torch.zeros(16000)
    >>> float(perceptual_evaluation_speech_quality(sig, sig, fs=16000, mode='wb', backend=toy_backend))
    4.5
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.data import input_device

try:  # pragma: no cover - only where the native package is installed
    import pesq as _pesq_backend  # type: ignore

    _PESQ_AVAILABLE = True
except ImportError:
    _pesq_backend = None
    _PESQ_AVAILABLE = False


def _host(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


def perceptual_evaluation_speech_quality(
    preds: Any,
    target: Any,
    fs: int,
    mode: str,
    keep_same_device: bool = False,
    n_processes: int = 1,
    backend: Optional[Callable] = None,
) -> Tensor:
    """PESQ score of each signal over the last axis."""
    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    if mode == "wb" and fs == 8000:
        raise ValueError("In wide band mode only sample rate of 16000 is supported")

    if backend is None:
        if not _PESQ_AVAILABLE:
            raise ModuleNotFoundError(
                "PESQ metric requires that pesq is installed. Either install as `pip install torchmetrics[audio]` "
                "or `pip install pesq`, or pass a custom `backend` callable."
            )
        backend = lambda _fs, t, p, _mode: _pesq_backend.pesq(_fs, t, p, _mode)  # noqa: E731

    device = input_device(preds)
    preds_np, target_np = _host(preds), _host(target)
    if preds_np.shape != target_np.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {preds_np.shape} and "
            f"{target_np.shape}."
        )
    flat_p = preds_np.reshape(-1, preds_np.shape[-1])
    flat_t = target_np.reshape(-1, target_np.shape[-1])
    vals = [float(backend(fs, t, p, mode)) for p, t in zip(flat_p, flat_t)]
    out = torch.tensor(vals, dtype=torch.float32, device=device).reshape(preds_np.shape[:-1] or (1,))
    return out[0] if preds_np.ndim == 1 else out
