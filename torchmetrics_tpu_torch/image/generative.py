"""Generative-model image metrics: FID, MiFID, KID, IS, LPIPS and PPL (counterpart of
``torchmetrics_tpu/image/generative.py``).

Every int ``feature`` (64, 192, 768, 2048) and the strings ``"inception"``,
``"logits"`` and ``"logits_unbiased"`` resolve the port's InceptionV3
(:mod:`torchmetrics_tpu_torch.image.backbones.inception`) on the metric's
device: weights from ``TORCHMETRICS_TPU_INCEPTION_WEIGHTS`` (a torch or
``.npz`` state_dict) when set, random-init otherwise; nothing is downloaded.
A callable ``(B, C, H, W) -> (B, D)`` can be passed instead;
``DeterministicFeatureExtractor`` is an explicit stand-in for quick tests.
States mirror the JAX package's: FID keeps float32 feature sums and
``features.T @ features`` (full float32) with int32 counts, MiFID, KID and
IS cat lists of features. FID's and MiFID's distances are float64 at
compute; KID's subsets go to one ``poly_mmd`` launch on the card.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.image import FrechetInceptionDistance
    >>> fid = FrechetInceptionDistance(feature=64, device="cpu")
    >>> imgs = torch.randint(0, 255, (4, 3, 32, 32), dtype=torch.uint8, generator=torch.Generator().manual_seed(0))
    >>> fid.update(imgs, real=True)
    >>> fid.update(imgs, real=False)
    >>> abs(round(float(fid.compute()), 4))  # identical distributions -> 0
    0.0
"""

from __future__ import annotations

import math
import os
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.image.generative import (
    _compute_fid,
    _mean_cov,
    _mifid_compute,
    inception_score_from_logits,
    kid_from_features,
)
from torchmetrics_tpu_torch.functional.image.lpips import (
    _default_net,
    _lpips_from_features,
    _same_pad,
    learned_perceptual_image_patch_similarity,
)
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat, resolve_device
from torchmetrics_tpu_torch.utilities.precision import full_float32


class DeterministicFeatureExtractor:
    """Seeded random conv encoder: ``(B, C, H, W)`` uint8 or float images -> ``(B, dim)`` features.

    ``num_layers`` stride-2 3 x 3 convolutions (``SAME`` padding, no bias) with ReLUs from 16 channels
    doubling, a spatial mean and a projection ``proj (C, dim)``; ``kernels`` and ``proj`` N(0, 1) over the
    square root of the fan-in, from a ``torch.Generator`` seeded ``seed`` (the JAX package's weights through
    ``convert.deterministic_features_from_jax``).
    """

    def __init__(self, dim: int = 64, seed: int = 0, num_layers: int = 3,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.num_features = dim
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.kernels = []
        in_ch, ch = 3, 16
        for _ in range(num_layers):
            self.kernels.append((torch.randn((ch, in_ch, 3, 3), generator=gen) / math.sqrt(9.0 * in_ch))
                                .to(self.device))
            in_ch, ch = ch, ch * 2
        self.proj = (torch.randn((in_ch, dim), generator=gen) / math.sqrt(float(in_ch))).to(self.device)

    def __call__(self, imgs: Any) -> Tensor:
        x = torch.as_tensor(imgs, device=self.device).to(torch.float32)
        if bool(x.max() > 1.5):  # pixel-scale input comes down to [0, 1]: one host read a batch
            x = x / 255.0
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        with full_float32():
            for w in self.kernels:
                x = F.relu(F.conv2d(_same_pad(x, 3, 2), w, stride=2))
            return x.mean(dim=(2, 3)) @ self.proj


def _maybe_to_uint8(imgs: Any, normalize: bool) -> Tensor:
    """[0, 1] floats to uint8 pixel scale when ``normalize``: ``(imgs * 255)`` truncated toward zero and, outside
    [0, 255], saturated, as XLA's cast is (numpy's and torch's own casts wrap there)."""
    imgs = torch.as_tensor(imgs)
    if normalize and imgs.is_floating_point():
        return (imgs * 255).clamp(0, 255).to(torch.uint8)
    return imgs


class _RealFeaturesResetMixin:
    """Keeps the real features' cat list over ``reset`` under ``reset_real_features=False``."""

    def reset(self) -> None:
        if not self.reset_real_features:
            saved = self._state["real_features"]
            super().reset()
            self._state["real_features"] = saved
        else:
            super().reset()


def _load_inception(feature: str = "pool", device: Optional[torch.device] = None, weights_path: Optional[str] = None):
    """The port's InceptionV3 extractor of one tap on ``device``: weights from ``weights_path`` or
    ``TORCHMETRICS_TPU_INCEPTION_WEIGHTS`` (``.npz`` or a torch ``state_dict``), random-init otherwise."""
    from torchmetrics_tpu_torch.image.backbones.inception import InceptionFeatureExtractor

    weights_path = weights_path or os.environ.get("TORCHMETRICS_TPU_INCEPTION_WEIGHTS")
    if weights_path:
        sd = dict(np.load(weights_path)) if weights_path.endswith(".npz") else torch.load(weights_path,
                                                                                          map_location="cpu")
        return InceptionFeatureExtractor.from_torch_state_dict(sd, feature=feature, device=device)
    return InceptionFeatureExtractor(feature=feature, device=device)


def _resolve_feature_extractor(feature: Union[int, str, Callable, None], device: torch.device,
                               default_dim: int = 2048) -> Tuple[Callable, int]:
    """``(extractor, dim)`` of a ``feature`` argument: an InceptionV3 tap for 64, 192, 768, 2048, ``"inception"``
    (the pool), ``"logits"`` and ``"logits_unbiased"``; a callable as it is (its ``num_features``, or the width
    of its output on a zero 32 x 32 batch)."""
    if feature is None:
        feature = default_dim
    if isinstance(feature, str):
        if feature == "inception":
            net = _load_inception("pool", device)
            return net, net.num_features
        if feature in ("logits", "logits_unbiased"):
            from torchmetrics_tpu_torch.image.backbones.inception import NUM_LOGITS

            return _load_inception(feature, device), NUM_LOGITS
        raise ValueError(f"Got unknown input to argument `feature`: {feature!r}")
    if isinstance(feature, int):
        valid_int_input = (64, 192, 768, 2048)
        if feature not in valid_int_input:
            raise ValueError(
                f"Integer input to argument `feature` must be one of {valid_int_input}, but got {feature}."
            )
        return _load_inception("pool" if feature == 2048 else str(feature), device), feature
    if callable(feature):
        dim = getattr(feature, "num_features", None)
        if dim is None:
            dim = feature(torch.zeros((1, 3, 32, 32), device=device)).shape[-1]
        return feature, int(dim)
    raise TypeError(f"Got unknown input to argument `feature`: {feature}")


def _check_flag(name: str, value: Any) -> None:
    if not isinstance(value, bool):
        raise ValueError(f"Argument `{name}` expected to be a bool")


class FrechetInceptionDistance(Metric):
    """FID with streaming float32 feature sums and ``features.T @ features`` states; float64 at compute."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        feature: Union[int, Callable, None] = 2048,
        reset_real_features: bool = True,
        normalize: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.inception, num_features = _resolve_feature_extractor(feature, self.device)
        _check_flag("reset_real_features", reset_real_features)
        _check_flag("normalize", normalize)
        self.reset_real_features = reset_real_features
        self.normalize = normalize
        self.num_features = num_features
        for prefix in ("real", "fake"):
            self.add_state(f"{prefix}_features_sum", torch.zeros(num_features), dist_reduce_fx="sum")
            self.add_state(f"{prefix}_features_cov_sum", torch.zeros((num_features, num_features)),
                           dist_reduce_fx="sum")
            self.add_state(f"{prefix}_features_num_samples", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def _update(self, state: State, imgs: Any, real: bool) -> State:
        features = torch.as_tensor(self.inception(_maybe_to_uint8(imgs, self.normalize)), device=self.device)
        features = features.to(torch.float32)
        prefix = "real" if real else "fake"
        with full_float32():
            cov = features.T @ features
        new = dict(state)
        new[f"{prefix}_features_sum"] = state[f"{prefix}_features_sum"] + features.sum(dim=0)
        new[f"{prefix}_features_cov_sum"] = state[f"{prefix}_features_cov_sum"] + cov
        new[f"{prefix}_features_num_samples"] = state[f"{prefix}_features_num_samples"] + features.shape[0]
        return new

    def _compute(self, state: State) -> Tensor:
        n_real, n_fake = int(state["real_features_num_samples"]), int(state["fake_features_num_samples"])
        if n_real < 2 or n_fake < 2:
            raise RuntimeError("More than one sample is required for both the real and fake distributed to compute FID")
        mu_real, cov_real = _mean_cov(state["real_features_sum"].double(), state["real_features_cov_sum"].double(),
                                      float(n_real))
        mu_fake, cov_fake = _mean_cov(state["fake_features_sum"].double(), state["fake_features_cov_sum"].double(),
                                      float(n_fake))
        return _compute_fid(mu_real, cov_real, mu_fake, cov_fake).to(torch.float32)

    def reset(self) -> None:
        """Keep the real statistics under ``reset_real_features=False``."""
        if not self.reset_real_features:
            saved = {k: self._state[k]
                     for k in ("real_features_sum", "real_features_cov_sum", "real_features_num_samples")}
            super().reset()
            self._state.update(saved)
        else:
            super().reset()


class MemorizationInformedFrechetInceptionDistance(_RealFeaturesResetMixin, Metric):
    """MiFID over cat lists of the real and fake features, float64 at compute."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        feature: Union[int, Callable, None] = 2048,
        reset_real_features: bool = True,
        normalize: bool = False,
        cosine_distance_eps: float = 0.1,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.inception, self.num_features = _resolve_feature_extractor(feature, self.device)
        _check_flag("reset_real_features", reset_real_features)
        _check_flag("normalize", normalize)
        if not (isinstance(cosine_distance_eps, float) and 1 >= cosine_distance_eps > 0):
            raise ValueError("Argument `cosine_distance_eps` expected to be a float greater than 0 and less than 1")
        self.reset_real_features = reset_real_features
        self.normalize = normalize
        self.cosine_distance_eps = cosine_distance_eps
        self.add_state("real_features", [], dist_reduce_fx="cat")
        self.add_state("fake_features", [], dist_reduce_fx="cat")

    def _update(self, state: State, imgs: Any, real: bool) -> State:
        features = torch.as_tensor(self.inception(_maybe_to_uint8(imgs, self.normalize)), device=self.device)
        key = "real_features" if real else "fake_features"
        return {**state, key: state[key] + (features.to(torch.float32),)}

    def _compute(self, state: State) -> Tensor:
        real = dim_zero_cat(state["real_features"]).double()
        fake = dim_zero_cat(state["fake_features"]).double()
        return _mifid_compute(real.mean(dim=0), torch.cov(real.T), real, fake.mean(dim=0), torch.cov(fake.T), fake,
                              self.cosine_distance_eps).to(torch.float32)


class KernelInceptionDistance(_RealFeaturesResetMixin, Metric):
    """KID's mean and standard deviation over random feature subsets, every subset in one ``poly_mmd`` launch."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        feature: Union[int, Callable, None] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        normalize: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.inception, self.num_features = _resolve_feature_extractor(feature, self.device)
        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        _check_flag("reset_real_features", reset_real_features)
        _check_flag("normalize", normalize)
        self.subsets = subsets
        self.subset_size = subset_size
        self.degree = degree
        self.gamma = gamma
        self.coef = coef
        self.reset_real_features = reset_real_features
        self.normalize = normalize
        self.add_state("real_features", [], dist_reduce_fx="cat")
        self.add_state("fake_features", [], dist_reduce_fx="cat")

    def _update(self, state: State, imgs: Any, real: bool) -> State:
        features = torch.as_tensor(self.inception(_maybe_to_uint8(imgs, self.normalize)), device=self.device)
        key = "real_features" if real else "fake_features"
        return {**state, key: state[key] + (features,)}

    def _compute(self, state: State) -> Tuple[Tensor, Tensor]:
        real = dim_zero_cat(state["real_features"])
        fake = dim_zero_cat(state["fake_features"])
        return kid_from_features(real, fake, self.subsets, self.subset_size, self.degree, self.gamma, self.coef)


class InceptionScore(Metric):
    """IS's mean and standard deviation over splits of a cat list of logits."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        feature: Union[int, str, Callable, None] = "logits_unbiased",
        splits: int = 10,
        normalize: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.inception, self.num_features = _resolve_feature_extractor(feature, self.device)
        if not (isinstance(splits, int) and splits > 0):
            raise ValueError("Argument `splits` expected to be integer larger than 0")
        _check_flag("normalize", normalize)
        self.splits = splits
        self.normalize = normalize
        self.add_state("features", [], dist_reduce_fx="cat")

    def _update(self, state: State, imgs: Any) -> State:
        features = torch.as_tensor(self.inception(_maybe_to_uint8(imgs, self.normalize)), device=self.device)
        return {**state, "features": state["features"] + (features,)}

    def _compute(self, state: State) -> Tuple[Tensor, Tensor]:
        return inception_score_from_logits(dim_zero_cat(state["features"]), self.splits)


class LearnedPerceptualImagePatchSimilarity(Metric):
    """LPIPS with float32 sum and count states; the backbone of ``net_type`` on the metric's device, or ``net``."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        net_type: str = "alex",
        reduction: str = "mean",
        normalize: bool = False,
        net: Optional[Callable] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if net_type not in ("alex", "vgg", "squeeze"):
            raise ValueError(f"Argument `net_type` must be one of 'alex', 'vgg', 'squeeze', but got {net_type}")
        if reduction not in ("mean", "sum"):
            raise ValueError(f"Argument `reduction` must be one of 'mean', 'sum', but got {reduction}")
        if not isinstance(normalize, bool):
            raise ValueError(f"Argument `normalize` should be a bool but got {normalize}")
        self.net_type = net_type
        self.reduction = reduction
        self.normalize = normalize
        self.net = net if net is not None else _default_net(net_type, self.device)
        self.add_state("sum_scores", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def _update(self, state: State, img1: Any, img2: Any) -> State:
        img1, img2 = self._tensor(img1), self._tensor(img2)
        loss = learned_perceptual_image_patch_similarity(img1, img2, self.net_type, reduction="sum",
                                                         normalize=self.normalize, net=self.net)
        return {"sum_scores": state["sum_scores"] + loss, "total": state["total"] + float(img1.shape[0])}

    def _compute(self, state: State) -> Tensor:
        if self.reduction == "mean":
            return state["sum_scores"] / state["total"]
        return state["sum_scores"]


def _interpolate(z1: Tensor, z2: Tensor, t: Tensor, method: str) -> Tensor:
    """``lerp``, or spherical (``slerp_any``; ``slerp_unit`` then normalizes) interpolation of latents."""
    if method == "lerp":
        return z1 + (z2 - z1) * t
    z1n = z1 / torch.linalg.norm(z1, dim=-1, keepdim=True)
    z2n = z2 / torch.linalg.norm(z2, dim=-1, keepdim=True)
    omega = torch.arccos(torch.clamp((z1n * z2n).sum(-1, keepdim=True), -1, 1))
    so = torch.sin(omega)
    out = torch.sin((1.0 - t) * omega) / so * z1 + torch.sin(t * omega) / so * z2
    if method == "slerp_unit":
        out = out / torch.linalg.norm(out, dim=-1, keepdim=True)
    return out


class PerceptualPathLength(Metric):
    """PPL: the LPIPS distance of images generated from latents ``epsilon`` apart, over ``epsilon ** 2``.

    The generator exposes ``sample(generator: torch.Generator, n) -> latents`` and is callable
    ``generator(z)`` (``generator(z, labels)`` and ``num_classes`` when ``conditional``), giving images in
    [-1, 1]. Each update draws its latents, ``t`` and labels from a ``torch.Generator`` on the metric's device
    seeded with the update count (the JAX package's PRNG draws differ); images are resized to ``resize`` as
    ``jax.image.resize`` does; ``compute`` drops the distances outside the ``lower_discard`` and
    ``upper_discard`` quantiles (linear, as ``np.quantile``) and gives their mean, standard deviation (ddof 0)
    and the kept distances.
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(
        self,
        num_samples: int = 10_000,
        conditional: bool = False,
        batch_size: int = 64,
        interpolation_method: str = "lerp",
        epsilon: float = 1e-4,
        resize: Optional[int] = 64,
        lower_discard: Optional[float] = 0.01,
        upper_discard: Optional[float] = 0.99,
        sim_net: Optional[Callable] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_samples, int) and num_samples > 0):
            raise ValueError(f"Argument `num_samples` must be a positive integer, but got {num_samples}")
        if interpolation_method not in ("lerp", "slerp_any", "slerp_unit"):
            raise ValueError(
                "Argument `interpolation_method` must be one of 'lerp', 'slerp_any', 'slerp_unit', "
                f"got {interpolation_method}"
            )
        if not (isinstance(epsilon, float) and epsilon > 0):
            raise ValueError(f"Argument `epsilon` must be a positive float, but got {epsilon}")
        for name, val in (("lower_discard", lower_discard), ("upper_discard", upper_discard)):
            if val is not None and not (isinstance(val, float) and 0 <= val <= 1):
                raise ValueError(f"Argument `{name}` must be a float between 0 and 1 or None, but got {val}")
        self.num_samples = num_samples
        self.conditional = conditional
        self.batch_size = batch_size
        self.interpolation_method = interpolation_method
        self.epsilon = epsilon
        self.resize = resize
        self.lower_discard = lower_discard
        self.upper_discard = upper_discard
        self.sim_net = sim_net if sim_net is not None else _default_net("vgg", self.device)
        self.add_state("distances", [], dist_reduce_fx="cat")

    _interpolate = staticmethod(_interpolate)

    def _distances(self, generator: Any, z1: Tensor, z2: Tensor, t: Tensor, labels: Optional[Tensor]) -> Tensor:
        """One batch's scaled LPIPS distances between the images of ``z(t)`` and ``z(t + epsilon)``."""
        from torchmetrics_tpu_torch.image.backbones.inception import resize_bilinear

        za = self._interpolate(z1, z2, t, self.interpolation_method)
        zb = self._interpolate(z1, z2, t + self.epsilon, self.interpolation_method)
        with torch.no_grad():
            img_a = torch.as_tensor(generator(za, labels) if labels is not None else generator(za))
            img_b = torch.as_tensor(generator(zb, labels) if labels is not None else generator(zb))
        if self.resize is not None:
            img_a = resize_bilinear(img_a.to(torch.float32), (self.resize, self.resize))
            img_b = resize_bilinear(img_b.to(torch.float32), (self.resize, self.resize))
        return _lpips_from_features(self.sim_net(img_a), self.sim_net(img_b),
                                    getattr(self.sim_net, "lin_weights", None)) / self.epsilon**2

    def _update(self, state: State, generator: Any) -> State:
        if not hasattr(generator, "sample") or not callable(generator):
            raise NotImplementedError(
                "The generator must be callable and have a `sample` method (generator, num_samples) -> latents."
            )
        if self.conditional and not hasattr(generator, "num_classes"):
            raise AttributeError(
                "Conditional PPL requires the generator to expose a `num_classes` attribute "
                "and accept `generator(z, labels)`."
            )
        rng = torch.Generator(device=self.device).manual_seed(int(state["_n"]))
        distances, done = [], 0
        while done < self.num_samples:
            n = min(self.batch_size, self.num_samples - done)
            z1 = torch.as_tensor(generator.sample(rng, n), device=self.device)
            z2 = torch.as_tensor(generator.sample(rng, n), device=self.device)
            t = torch.rand((n, 1), generator=rng, device=self.device)
            labels = (torch.randint(0, int(generator.num_classes), (n,), generator=rng, device=self.device)
                      if self.conditional else None)
            distances.append(self._distances(generator, z1, z2, t, labels))
            done += n
        return {"distances": state["distances"] + (torch.cat(distances),)}

    def _compute(self, state: State) -> Tuple[Tensor, Tensor, Tensor]:
        distances = dim_zero_cat(state["distances"])
        lower = torch.quantile(distances, self.lower_discard) if self.lower_discard is not None else distances.min()
        upper = torch.quantile(distances, self.upper_discard) if self.upper_discard is not None else distances.max()
        kept = distances[(distances >= lower) & (distances <= upper)]
        return kept.mean(), kept.std(correction=0), kept.to(torch.float32)
