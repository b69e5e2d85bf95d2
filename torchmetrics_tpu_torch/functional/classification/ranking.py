"""Multilabel ranking (counterpart of ``torchmetrics_tpu/functional/classification/ranking.py``).

Coverage error, label ranking average precision and ranking loss: a value a
sample, then their mean, as in the JAX functions. On a CUDA tensor the
per-sample values are one launch of the ``ranking_pairs`` kernel
(``csrc/ranking.cu``), which for LRAP and the loss sorts each row's labels
by score and scans them once, instead of building the JAX functions'
``(N, L, L)`` float32 comparison tensors; on the CPU they are the plain
version below, those formulas transliterated.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.ranking import multilabel_ranking_average_precision
    >>> preds = torch.tensor([[0.75, 0.05, 0.35], [0.45, 0.6, 0.1]])
    >>> target = torch.tensor([[1, 0, 1], [0, 0, 1]])
    >>> round(float(multilabel_ranking_average_precision(preds, target, num_labels=3)), 4)
    0.6667
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import _as_tensors
from torchmetrics_tpu_torch.kernels.ranking import ranking_pairs


def _format_ranking_inputs(preds: Tensor, target: Tensor, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor, Tensor]:
    """float32 ``(preds, target, valid)``: ignored targets set to 0 and marked invalid."""
    valid = torch.ones(target.shape, dtype=torch.float32, device=target.device)
    if ignore_index is not None:
        ignored = target == ignore_index
        valid = torch.where(ignored, 0.0, valid)
        target = torch.where(ignored, 0, target)
    return preds.to(torch.float32), target.to(torch.float32), valid


def _coverage_plain(preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
    relevant = (target * valid) > 0
    inf = torch.full_like(preds, float("inf"))
    candidates = torch.where(relevant, preds, inf)
    # jnp.min propagates NaN: say so rather than rely on the reduction of each device
    min_relevant = torch.where(candidates.isnan().any(1), float("nan"), candidates.amin(1))
    coverage = ((preds >= min_relevant[:, None]) * valid).sum(1)
    return torch.where(torch.isinf(min_relevant), 0.0, coverage)


def _lrap_plain(preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
    rel = target * valid
    ge = (preds[:, :, None] <= preds[:, None, :]).to(torch.float32)  # ge[n, i, j] = score_j >= score_i
    rank_all = torch.einsum("nij,nj->ni", ge, valid)
    rank_rel = torch.einsum("nij,nj->ni", ge, rel)
    per_label = torch.where(rel > 0, rank_rel / rank_all, 0.0)
    n_rel = rel.sum(1)
    per_sample = torch.where(n_rel > 0, per_label.sum(1) / torch.clamp_min(n_rel, 1.0), 1.0)
    return torch.where(n_rel == valid.sum(1), 1.0, per_sample)  # every valid label relevant


def _loss_plain(preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
    rel = target * valid
    irr = (1.0 - target) * valid
    ge = (preds[:, None, :] >= preds[:, :, None]).to(torch.float32)  # ge[n, i, j] = score_j >= score_i
    bad = torch.einsum("nij,ni,nj->n", ge, rel, irr)
    denom = rel.sum(1) * irr.sum(1)
    return torch.where(denom > 0, bad / torch.clamp_min(denom, 1.0), 0.0)


_PLAIN = {"coverage": _coverage_plain, "lrap": _lrap_plain, "loss": _loss_plain}


def _ranking_per_sample_plain(preds: Tensor, target: Tensor, measure: str, ignore_index: Optional[int]) -> Tensor:
    """Plain PyTorch ``ranking_pairs``: the JAX formulas, float32 ``(N,)`` before the mean."""
    return _PLAIN[measure](*_format_ranking_inputs(preds, target, ignore_index))


def _ranking_per_sample(preds: Tensor, target: Tensor, measure: str, ignore_index: Optional[int]) -> Tensor:
    """Per-sample ``measure``: one ``ranking_pairs`` launch on a CUDA tensor (it raises if it
    cannot launch), the plain version on a CPU tensor."""
    if preds.device.type == "cpu":
        return _ranking_per_sample_plain(preds, target, measure, ignore_index)
    if target.dtype not in (torch.int32, torch.int64):
        target = target.to(torch.int32)
    return ranking_pairs(preds.to(torch.float32).contiguous(), target.contiguous(), measure, ignore_index)


def multilabel_coverage_error(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None, validate_args: bool = True
) -> Tensor:
    """How far down the ranking to go to cover all true labels (sklearn ``coverage_error``)."""
    return _ranking_per_sample(*_as_tensors(preds, target), "coverage", ignore_index).mean()


def multilabel_ranking_average_precision(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None, validate_args: bool = True
) -> Tensor:
    """Label ranking average precision (sklearn ``label_ranking_average_precision_score``)."""
    return _ranking_per_sample(*_as_tensors(preds, target), "lrap", ignore_index).mean()


def multilabel_ranking_loss(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None, validate_args: bool = True
) -> Tensor:
    """Average fraction of mis-ordered (relevant, irrelevant) label pairs (sklearn ``label_ranking_loss``)."""
    return _ranking_per_sample(*_as_tensors(preds, target), "loss", ignore_index).mean()
