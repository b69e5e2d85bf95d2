"""Spectral and remote-sensing metric classes and total variation
(counterpart of ``torchmetrics_tpu/image/spectral.py``).

The metrics whose formula does not decompose into sums keep ``preds`` and
``target`` (D-s and QNR: ``preds``, ``ms``, ``pan``, ``pan_lr``) as cat
lists, as the JAX classes do; VIF keeps float32 sums, total variation sums
or a cat list of per-image scores.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.image import TotalVariation
    >>> metric = TotalVariation(device="cpu")
    >>> metric.update(torch.arange(48.0).reshape(1, 3, 4, 4) / 48.0)
    >>> round(float(metric.compute()), 4)
    3.75
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.image.spectral import (
    _rmse_sw_compute,
    _rmse_sw_update,
    error_relative_global_dimensionless_synthesis,
    quality_with_no_reference,
    relative_average_spectral_error,
    spatial_correlation_coefficient,
    spatial_distortion_index,
    spectral_angle_mapper,
    spectral_distortion_index,
    universal_image_quality_index,
    visual_information_fidelity,
)
from torchmetrics_tpu_torch.functional.image.tv import _total_variation_compute, _total_variation_update
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class _CatPredsTargetMetric(Metric):
    """Base: the raw preds and target as cat lists, the functional at compute."""

    is_differentiable = True
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        return {"preds": state["preds"] + (self._tensor(preds),), "target": state["target"] + (self._tensor(target),)}

    def _cat(self, state: State):
        return dim_zero_cat(state["preds"]), dim_zero_cat(state["target"])


class UniversalImageQualityIndex(_CatPredsTargetMetric):
    """UQI."""

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, kernel_size: Sequence[int] = (11, 11), sigma: Sequence[float] = (1.5, 1.5),
                 reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction

    def _compute(self, state: State) -> Tensor:
        return universal_image_quality_index(*self._cat(state), self.kernel_size, self.sigma, self.reduction)


class SpectralAngleMapper(_CatPredsTargetMetric):
    """SAM."""

    higher_is_better = False
    plot_lower_bound = 0.0

    def __init__(self, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.reduction = reduction

    def _compute(self, state: State) -> Tensor:
        return spectral_angle_mapper(*self._cat(state), self.reduction)


class SpatialCorrelationCoefficient(_CatPredsTargetMetric):
    """SCC."""

    higher_is_better = True
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def __init__(self, hp_filter: Optional[Tensor] = None, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.hp_filter = hp_filter
        self.window_size = window_size

    def _compute(self, state: State) -> Tensor:
        return spatial_correlation_coefficient(*self._cat(state), self.hp_filter, self.window_size)


class ErrorRelativeGlobalDimensionlessSynthesis(_CatPredsTargetMetric):
    """ERGAS."""

    higher_is_better = False
    plot_lower_bound = 0.0

    def __init__(self, ratio: float = 4, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.ratio = ratio
        self.reduction = reduction

    def _compute(self, state: State) -> Tensor:
        return error_relative_global_dimensionless_synthesis(*self._cat(state), self.ratio, self.reduction)


class RelativeAverageSpectralError(_CatPredsTargetMetric):
    """RASE."""

    higher_is_better = False
    plot_lower_bound = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError(f"Argument `window_size` is expected to be a positive integer, but got {window_size}")
        self.window_size = window_size

    def _compute(self, state: State) -> Tensor:
        return relative_average_spectral_error(*self._cat(state), self.window_size)


class RootMeanSquaredErrorUsingSlidingWindow(_CatPredsTargetMetric):
    """RMSE-SW."""

    higher_is_better = False
    plot_lower_bound = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError("Argument `window_size` is expected to be a positive integer.")
        self.window_size = window_size

    def _compute(self, state: State) -> Tensor:
        rmse_val_sum, rmse_map, total = _rmse_sw_update(*self._cat(state), self.window_size, None, None, None)
        return _rmse_sw_compute(rmse_val_sum, rmse_map, total)[0]


class SpectralDistortionIndex(_CatPredsTargetMetric):
    """D-lambda."""

    higher_is_better = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, p: int = 1, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(p, int) or p <= 0:
            raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
        self.p = p
        self.reduction = reduction

    def _compute(self, state: State) -> Tensor:
        return spectral_distortion_index(*self._cat(state), self.p, self.reduction)


class SpatialDistortionIndex(Metric):
    """D-s; ``update(preds, {"ms": ..., "pan": ..., "pan_lr": ...})`` (``pan_lr`` optional)."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, norm_order: int = 1, window_size: int = 7, reduction: Optional[str] = "elementwise_mean",
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.norm_order = norm_order
        self.window_size = window_size
        self.reduction = reduction
        for name in ("preds", "ms", "pan", "pan_lr"):
            self.add_state(name, [], dist_reduce_fx="cat")

    def _update(self, state: State, preds: Tensor, target: dict) -> State:
        if "ms" not in target or "pan" not in target:
            raise ValueError(f"Expected `target` to have keys ('ms', 'pan'). Got {list(target)}.")
        new = dict(state)
        new["preds"] = state["preds"] + (self._tensor(preds),)
        new["ms"] = state["ms"] + (self._tensor(target["ms"]),)
        new["pan"] = state["pan"] + (self._tensor(target["pan"]),)
        if "pan_lr" in target:
            new["pan_lr"] = state["pan_lr"] + (self._tensor(target["pan_lr"]),)
        return new

    def _inputs(self, state: State):
        pan_lr = dim_zero_cat(state["pan_lr"]) if state["pan_lr"] else None
        return dim_zero_cat(state["preds"]), dim_zero_cat(state["ms"]), dim_zero_cat(state["pan"]), pan_lr

    def _compute(self, state: State) -> Tensor:
        return spatial_distortion_index(*self._inputs(state), self.norm_order, self.window_size, self.reduction)


class QualityWithNoReference(SpatialDistortionIndex):
    """QNR."""

    higher_is_better = True

    def __init__(self, alpha: float = 1.0, beta: float = 1.0, norm_order: int = 1, window_size: int = 7,
                 reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(norm_order=norm_order, window_size=window_size, reduction=reduction, **kwargs)
        if not isinstance(alpha, (int, float)) or alpha < 0:
            raise ValueError(f"Expected `alpha` to be a non-negative real number. Got alpha: {alpha}.")
        if not isinstance(beta, (int, float)) or beta < 0:
            raise ValueError(f"Expected `beta` to be a non-negative real number. Got beta: {beta}.")
        self.alpha = alpha
        self.beta = beta

    def _compute(self, state: State) -> Tensor:
        return quality_with_no_reference(*self._inputs(state), self.alpha, self.beta, self.norm_order,
                                         self.window_size, self.reduction)


class VisualInformationFidelity(Metric):
    """VIF-p; its per-batch value times the batch size, summed."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, sigma_n_sq: float = 2.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(sigma_n_sq, (int, float)) or sigma_n_sq < 0:
            raise ValueError(f"Argument `sigma_n_sq` is expected to be a positive float or int, but got {sigma_n_sq}")
        self.sigma_n_sq = sigma_n_sq
        self.add_state("vif_score", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        preds, target = self._tensor(preds), self._tensor(target)
        score = visual_information_fidelity(preds, target, self.sigma_n_sq)
        return {"vif_score": state["vif_score"] + score * preds.shape[0], "total": state["total"] + preds.shape[0]}

    def _compute(self, state: State) -> Tensor:
        return state["vif_score"] / state["total"]


class TotalVariation(Metric):
    """Total variation."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction is not None and reduction not in ("sum", "mean", "none"):
            raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")
        self.reduction = reduction
        if reduction in (None, "none"):
            self.add_state("score_list", [], dist_reduce_fx="cat")
        else:
            self.add_state("score", torch.zeros(()), dist_reduce_fx="sum")
            self.add_state("num_elements", torch.zeros(()), dist_reduce_fx="sum")

    def _update(self, state: State, img: Tensor) -> State:
        score, num = _total_variation_update(self._tensor(img))
        if self.reduction in (None, "none"):
            return {"score_list": state["score_list"] + (score,)}
        return {"score": state["score"] + score.sum(), "num_elements": state["num_elements"] + num}

    def _compute(self, state: State) -> Tensor:
        if self.reduction in (None, "none"):
            return dim_zero_cat(state["score_list"])
        return _total_variation_compute(state["score"], state["num_elements"], self.reduction)
