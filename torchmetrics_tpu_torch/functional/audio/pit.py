"""Permutation Invariant Training (counterpart of ``torchmetrics_tpu/functional/audio/pit.py``).

All ``spk!`` assignments are scored from one batched metric call, as in JAX.
Speaker-wise mode builds the ``(B, spk, spk)`` matrix ``[b, target j,
estimate i]``: for the port's own SNR, SI-SNR and SI-SDR on float32 signals
on the card it is one launch of the ``snr_moments`` kernel's pairs mode, which
reads each row once and tiles nothing (``_PAIR_METRICS``); any other metric,
and those elsewhere, take JAX's tile of both signals ``spk`` times and one
call of the metric. Up to 3 speakers the search is exhaustive; past that the
host's ``scipy.optimize.linear_sum_assignment`` picks the permutation and the
metric is gathered from the matrix. Ties go to the first index, as
``jnp.argmax`` gives them.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.audio.pit import permutation_invariant_training, pit_permutate
    >>> from torchmetrics_tpu_torch.functional.audio.snr import scale_invariant_signal_noise_ratio
    >>> target = torch.tensor([[[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]])
    >>> preds = target.flip(1)  # speakers swapped
    >>> best_metric, best_perm = permutation_invariant_training(preds, target, scale_invariant_signal_noise_ratio)
    >>> best_perm
    tensor([[0, 1]], dtype=torch.int32)
    >>> bool(torch.allclose(pit_permutate(preds, best_perm), target))
    False
"""

from __future__ import annotations

from functools import lru_cache
from itertools import permutations
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio
from torchmetrics_tpu_torch.functional.audio.snr import (
    _as_signals,
    _on_kernel,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)
from torchmetrics_tpu_torch.kernels.snr_moments import MAX_SPEAKERS, snr_moments

# the metrics whose speaker-wise matrix is snr_moments' pairs mode: (scale_invariant, the kwargs they take,
# zero_mean when not given)
_PAIR_METRICS = {
    signal_noise_ratio: (False, {"zero_mean"}, False),
    scale_invariant_signal_noise_ratio: (True, set(), True),
    scale_invariant_signal_distortion_ratio: (True, {"zero_mean"}, False),
}


@lru_cache(maxsize=32)
def _gen_permutations(spk_num: int) -> np.ndarray:
    return np.asarray(list(permutations(range(spk_num))))


def _perms(spk_num: int, device: torch.device) -> Tensor:
    return torch.as_tensor(_gen_permutations(spk_num), dtype=torch.int32, device=device)


def _find_best_perm_by_exhaustive_method(metric_mtx: Tensor, eval_func: str) -> Tuple[Tensor, Tensor]:
    """Best permutation of the ``(B, spk, spk)`` matrix: every permutation's score, its arg max or min."""
    spk_num = metric_mtx.shape[-1]
    perms = _perms(spk_num, metric_mtx.device).long()  # (P, spk)
    t_idx = torch.arange(spk_num, device=metric_mtx.device)
    scores = metric_mtx[:, t_idx, perms].sum(dim=-1)  # (B, P): sum over t of mtx[t, perm[t]]
    if eval_func == "max":
        best = torch.argmax(scores, dim=-1)
        best_metric = scores.max(dim=-1).values / spk_num
    else:
        best = torch.argmin(scores, dim=-1)
        best_metric = scores.min(dim=-1).values / spk_num
    return best_metric, perms[best].to(torch.int32)


def _find_best_perm_by_linear_sum_assignment(metric_mtx: Tensor, eval_func: str) -> Tuple[Tensor, Tensor]:
    """The host's Hungarian assignment of each item; the metric gathered from the matrix."""
    from scipy.optimize import linear_sum_assignment

    mtx = metric_mtx.detach().cpu().numpy()
    best_perms = np.stack([linear_sum_assignment(m, maximize=(eval_func == "max"))[1] for m in mtx])
    perm = torch.as_tensor(best_perms, dtype=torch.int32, device=metric_mtx.device)
    b_idx = torch.arange(metric_mtx.shape[0], device=metric_mtx.device)[:, None]
    t_idx = torch.arange(metric_mtx.shape[-1], device=metric_mtx.device)[None, :]
    best_metric = metric_mtx[b_idx, t_idx, perm.long()].mean(dim=-1)
    return best_metric, perm


def _pairs_matrix(preds: Tensor, target: Tensor, metric_func: Callable, kwargs: Dict[str, Any]) -> Optional[Tensor]:
    """The speaker-wise matrix from one ``snr_moments`` pairs launch, where the metric and the inputs allow it."""
    spec = _PAIR_METRICS.get(metric_func)
    if spec is None or preds.ndim != 3 or preds.shape != target.shape or preds.shape[1] > MAX_SPEAKERS:
        return None
    scale_invariant, takes, zero_mean = spec
    if not set(kwargs) <= takes or not _on_kernel(preds, target):
        return None
    return snr_moments(preds.contiguous(), target.contiguous(), scale_invariant,
                       bool(kwargs.get("zero_mean", zero_mean)), pairs=True)


def permutation_invariant_training(
    preds: Any,
    target: Any,
    metric_func: Callable,
    mode: str = "speaker-wise",
    eval_func: str = "max",
    **kwargs: Any,
) -> Tuple[Tensor, Tensor]:
    """PIT: the best metric of each item ``(B,)`` and its permutation ``(B, spk)`` (int32)."""
    preds, target = _as_signals(preds, target)
    if preds.shape[0:2] != target.shape[0:2]:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape at the batch and speaker dimensions"
        )
    if eval_func not in ["max", "min"]:
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if mode not in ["speaker-wise", "permutation-wise"]:
        raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
    if target.ndim < 2:
        raise ValueError(f"Inputs must be of shape [batch, spk, ...], got {tuple(target.shape)} and "
                         f"{tuple(preds.shape)} instead")

    batch_size, spk_num = target.shape[0:2]

    if mode == "permutation-wise":
        perms = _perms(spk_num, preds.device)  # (P, spk)
        perm_num = perms.shape[0]
        ppreds = preds[:, perms.reshape(-1).long()].reshape(batch_size * perm_num, *preds.shape[1:])
        ptarget = torch.repeat_interleave(target, perm_num, dim=0)
        metric_of_ps = metric_func(ppreds, ptarget, **kwargs)
        metric_of_ps = torch.mean(metric_of_ps.reshape(batch_size, perm_num, -1), dim=-1)
        if eval_func == "max":
            best_indexes = torch.argmax(metric_of_ps, dim=1)
            best_metric = metric_of_ps.max(dim=1).values
        else:
            best_indexes = torch.argmin(metric_of_ps, dim=1)
            best_metric = metric_of_ps.min(dim=1).values
        return best_metric, perms[best_indexes]

    metric_mtx = _pairs_matrix(preds, target, metric_func, kwargs)
    if metric_mtx is None:  # JAX's tile: (B, spk_t, spk_p) rows of one batched call
        rest = preds.shape[2:]
        p_rep = preds[:, None].expand(batch_size, spk_num, spk_num, *rest)
        t_rep = target[:, :, None].expand(batch_size, spk_num, spk_num, *target.shape[2:])
        flat_p = p_rep.reshape(batch_size * spk_num * spk_num, *rest)
        flat_t = t_rep.reshape(batch_size * spk_num * spk_num, *target.shape[2:])
        metric_mtx = metric_func(flat_p, flat_t, **kwargs).reshape(batch_size, spk_num, spk_num)

    if spk_num <= 3:
        return _find_best_perm_by_exhaustive_method(metric_mtx, eval_func)
    return _find_best_perm_by_linear_sum_assignment(metric_mtx, eval_func)


def pit_permutate(preds: Any, perm: Any) -> Tensor:
    """``preds`` reordered along the speakers by ``perm``."""
    preds = preds if isinstance(preds, Tensor) else torch.as_tensor(preds)
    perm = torch.as_tensor(perm, device=preds.device).long()
    return torch.take_along_dim(preds, perm.reshape(perm.shape + (1,) * (preds.ndim - 2)), dim=1)
