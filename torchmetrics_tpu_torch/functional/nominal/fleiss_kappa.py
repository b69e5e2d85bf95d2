"""Fleiss' kappa inter-rater agreement (counterpart of ``torchmetrics_tpu/functional/nominal/fleiss_kappa.py``).

In ``probs`` mode each rater's category is ``jnp.argmax``'s: the first NaN,
else the lowest index of the maximum (``kernels.confmat._argmax_first``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.nominal.fleiss_kappa import fleiss_kappa
    >>> ratings = torch.tensor([[3, 0], [2, 1], [0, 3], [1, 2]])  # (subjects, categories) rater counts
    >>> round(float(fleiss_kappa(ratings, mode='counts')), 4)
    0.3333
"""

from __future__ import annotations

from typing import Literal

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels.confmat import _argmax_first
from torchmetrics_tpu_torch.utilities.data import input_device, to_tensor


def _fleiss_kappa_update(ratings: Tensor, mode: Literal["counts", "probs"] = "counts") -> Tensor:
    """Normalize ratings to an int32 (n_samples, n_categories) counts matrix."""
    ratings = to_tensor(ratings, input_device(ratings))
    if mode == "probs":
        if ratings.ndim != 3 or not ratings.is_floating_point():
            raise ValueError(
                "If argument ``mode`` is 'probs', ratings must have 3 dimensions with the format"
                " [n_samples, n_categories, n_raters] and be floating point."
            )
        n_categories = ratings.shape[1]
        choice = _argmax_first(ratings)  # (n_samples, n_raters)
        categories = torch.arange(n_categories, device=ratings.device)
        return (choice.unsqueeze(-1) == categories).sum(1).to(torch.int32)
    if mode == "counts" and (ratings.ndim != 2 or ratings.is_floating_point()):
        raise ValueError(
            "If argument ``mode`` is `counts`, ratings must have 2 dimensions with the format"
            " [n_samples, n_categories] and be none floating point."
        )
    return ratings


def _fleiss_kappa_compute(counts: Tensor) -> Tensor:
    counts = counts.to(torch.float32)
    total = counts.shape[0]
    num_raters = counts.sum(1).max()
    p_i = counts.sum(0) / (total * num_raters)
    p_j = ((counts * counts).sum(1) - num_raters) / (num_raters * (num_raters - 1))
    p_bar = p_j.mean()
    pe_bar = (p_i * p_i).sum()
    return (p_bar - pe_bar) / (1 - pe_bar + 1e-5)


def fleiss_kappa(ratings: Tensor, mode: Literal["counts", "probs"] = "counts") -> Tensor:
    """κ = (p̄ - p̄ₑ) / (1 - p̄ₑ); agreement between raters beyond chance."""
    if mode not in ("counts", "probs"):
        raise ValueError("Argument ``mode`` must be one of 'counts' or 'probs'.")
    return _fleiss_kappa_compute(_fleiss_kappa_update(ratings, mode))
