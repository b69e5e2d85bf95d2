"""Generative-model image metrics on features: FID, KID, Inception Score, MiFID
(counterpart of ``torchmetrics_tpu/functional/image/generative.py``).

FID takes the Frechet distance by the JAX package's symmetric route,
``tr((S1 S2)^(1/2)) = tr((S1^(1/2) S2 S1^(1/2))^(1/2))``, two
``torch.linalg.eigh``/``eigvalsh`` calls in float64 on the inputs' device,
eigenvalues clipped at 0. KID draws each subset with ``torch.randperm`` from
a ``torch.Generator`` (the JAX package's PRNG is not reproducible here) and
takes every subset's MMD^2 in one ``poly_mmd`` launch on the card
(:func:`~torchmetrics_tpu_torch.kernels.poly_mmd.poly_mmd_subsets`).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.image.generative import inception_score_from_logits
    >>> logits = torch.randn((8, 10), generator=torch.Generator().manual_seed(0))
    >>> mean, std = inception_score_from_logits(logits, splits=2)
    >>> bool(mean >= 1.0)  # IS is bounded below by 1
    True
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels.poly_mmd import (  # the plain forms under the JAX module's names
    _poly_mmd_plain,
    maximum_mean_discrepancy,  # noqa: F401
    poly_kernel,  # noqa: F401
    poly_mmd_subsets,
)


def _compute_fid(mu1: Tensor, sigma1: Tensor, mu2: Tensor, sigma2: Tensor) -> Tensor:
    """Frechet distance by two symmetric eigen-decompositions, in the inputs' dtype (float64 in the metrics)."""
    a = torch.square(mu1 - mu2).sum(dim=-1)
    b = torch.trace(sigma1) + torch.trace(sigma2)
    w1, v1 = torch.linalg.eigh(sigma1)
    sqrt_sigma1 = (v1 * torch.sqrt(torch.clamp(w1, min=0.0))) @ v1.T
    m = sqrt_sigma1 @ sigma2 @ sqrt_sigma1
    c = torch.sqrt(torch.clamp(torch.linalg.eigvalsh(m), min=0.0)).sum(dim=-1)
    return a + b - 2 * c


def _mean_cov(feat_sum: Tensor, feat_cov_sum: Tensor, n: float) -> Tuple[Tensor, Tensor]:
    """Mean and covariance from the streaming sums."""
    mean = (feat_sum / n)[None]
    cov_num = feat_cov_sum - n * (mean.T @ mean)
    return mean[0], cov_num / (n - 1)


def poly_mmd(f_real: Tensor, f_fake: Tensor, degree: int = 3, gamma: Optional[float] = None,
             coef: float = 1.0) -> Tensor:
    """The unbiased polynomial-kernel MMD^2 of two feature sets of the same size (plain float32)."""
    rows = torch.arange(f_real.shape[0], device=f_real.device)[None]
    gamma = 1.0 / f_real.shape[1] if gamma is None else gamma
    return _poly_mmd_plain(f_real, f_fake, rows, rows, degree, gamma, coef)[0]


def kid_from_features(
    real_features: Tensor,
    fake_features: Tensor,
    subsets: int = 100,
    subset_size: int = 1000,
    degree: int = 3,
    gamma: Optional[float] = None,
    coef: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Tensor, Tensor]:
    """KID's mean and standard deviation (ddof 1) over ``subsets`` random subsets of ``subset_size`` rows.

    Each subset's rows are the first ``subset_size`` of a ``torch.randperm`` drawn from ``generator`` (one
    seeded 0 on the features' device by default): the real subsets first, then the fake ones."""
    n_real, n_fake = real_features.shape[0], fake_features.shape[0]
    if n_real < subset_size or n_fake < subset_size:
        raise ValueError("Argument `subset_size` should be smaller than the number of samples")
    device = real_features.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    perm_r = torch.stack([torch.randperm(n_real, generator=generator, device=generator.device)[:subset_size]
                          for _ in range(subsets)]).to(device)
    perm_f = torch.stack([torch.randperm(n_fake, generator=generator, device=generator.device)[:subset_size]
                          for _ in range(subsets)]).to(device)
    gamma = 1.0 / real_features.shape[1] if gamma is None else gamma
    values = poly_mmd_subsets(real_features, fake_features, perm_r, perm_f, degree, gamma, coef)
    return values.mean(), values.std() if subsets > 1 else torch.zeros((), device=device)


def inception_score_from_logits(logits: Tensor, splits: int = 10) -> Tuple[Tensor, Tensor]:
    """IS = exp(mean KL(p(y|x) || p(y))) a split, its mean and standard deviation (ddof 1) over the splits.

    ``torch.tensor_split`` into ``min(splits, n)`` chunks gives ``np.array_split``'s sizes: every sample
    counts, and fewer samples than splits make fewer splits."""
    prob = torch.softmax(logits, dim=1)
    log_prob = torch.log_softmax(logits, dim=1)
    scores = []
    for p, lp in zip(torch.tensor_split(prob, min(splits, prob.shape[0])),
                     torch.tensor_split(log_prob, min(splits, prob.shape[0]))):
        mean_p = p.mean(dim=0, keepdim=True)
        kl = p * (lp - torch.log(torch.clamp(mean_p, min=1e-12)))
        scores.append(torch.exp(kl.sum(dim=1).mean()))
    scores_t = torch.stack(scores)
    return scores_t.mean(), scores_t.std() if len(scores) > 1 else torch.zeros((), device=logits.device)


def _compute_cosine_distance(features1: Tensor, features2: Tensor, cosine_distance_eps: float = 0.1) -> Tensor:
    """The mean over ``features1``'s rows of the least cosine distance to ``features2`` (all-zero-sum rows left
    out), or 1 where that mean is not below ``cosine_distance_eps``."""
    f1 = features1[features1.sum(dim=1) != 0]
    f2 = features2[features2.sum(dim=1) != 0]
    norm_f1 = f1 / torch.linalg.norm(f1, dim=1, keepdim=True)
    norm_f2 = f2 / torch.linalg.norm(f2, dim=1, keepdim=True)
    d = 1.0 - torch.abs(norm_f1 @ norm_f2.T)
    mean_min_d = d.min(dim=1).values.mean()
    return torch.where(mean_min_d < cosine_distance_eps, mean_min_d, torch.ones_like(mean_min_d))


def _mifid_compute(mu1: Tensor, sigma1: Tensor, features1: Tensor, mu2: Tensor, sigma2: Tensor, features2: Tensor,
                   cosine_distance_eps: float = 0.1) -> Tensor:
    """MiFID in float64: FID over the cosine gate, 0 where FID is at most 1e-8."""
    fid_value = _compute_fid(mu1, sigma1, mu2, sigma2)
    # the gate's value rounded to float32, as the JAX package hands it over
    distance = _compute_cosine_distance(features1, features2, cosine_distance_eps).to(torch.float32).to(fid_value.dtype)
    if float(fid_value) > 1e-8:
        return fid_value / (distance + 10e-15)
    return torch.zeros((), dtype=fid_value.dtype, device=fid_value.device)
