"""SSIM and MS-SSIM metric classes (counterpart of ``torchmetrics_tpu/image/ssim.py``).

The per-image similarity is kept as float32 sums (``similarity``, ``total``)
for the mean and sum reductions, else as a cat list, with the full maps or
the contrast sensitivities in ``image_return``. An update of a 4-D float32
batch on the card is one ``ssim_window`` launch (five for MS-SSIM).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.image import StructuralSimilarityIndexMeasure
    >>> metric = StructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
    >>> img = torch.arange(256.0).reshape(1, 1, 16, 16) / 256.0
    >>> metric.update(img, img * 0.9)
    >>> round(float(metric.compute()), 4)
    0.9893
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.image.ssim import _multiscale_ssim_update, _ssim_check_inputs, _ssim_update
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

_VALID_REDUCTIONS = ("elementwise_mean", "sum", "none", None)


class StructuralSimilarityIndexMeasure(Metric):
    """SSIM."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        gaussian_kernel: bool = True,
        sigma: Union[float, Sequence[float]] = 1.5,
        kernel_size: Union[int, Sequence[int]] = 11,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        return_full_image: bool = False,
        return_contrast_sensitivity: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if reduction not in _VALID_REDUCTIONS:
            raise ValueError(f"Argument `reduction` must be one of {_VALID_REDUCTIONS}, but got {reduction}")
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.return_full_image = return_full_image
        self.return_contrast_sensitivity = return_contrast_sensitivity
        if reduction in ("none", None) or return_full_image or return_contrast_sensitivity:
            self.add_state("similarity", [], dist_reduce_fx="cat")
        else:
            self.add_state("similarity", torch.zeros(()), dist_reduce_fx="sum")
            self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        if return_full_image or return_contrast_sensitivity:
            self.add_state("image_return", [], dist_reduce_fx="cat")

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        preds, target = _ssim_check_inputs(self._tensor(preds), self._tensor(target))
        out = _ssim_update(preds, target, self.gaussian_kernel, self.sigma, self.kernel_size, self.data_range,
                           self.k1, self.k2, self.return_full_image, self.return_contrast_sensitivity)
        new = dict(state)
        if isinstance(out, tuple):
            sim, extra = out
            new["image_return"] = state["image_return"] + (extra,)
        else:
            sim = out
        if isinstance(state["similarity"], tuple):
            new["similarity"] = state["similarity"] + (sim,)
        else:
            new["similarity"] = state["similarity"] + sim.sum()
            new["total"] = state["total"] + sim.shape[0]
        return new

    def _compute(self, state: State):
        if isinstance(state["similarity"], tuple):
            sim = dim_zero_cat(state["similarity"])
            if self.reduction == "elementwise_mean":
                sim = sim.mean()
            elif self.reduction == "sum":
                sim = sim.sum()
            if self.return_full_image or self.return_contrast_sensitivity:
                return sim, dim_zero_cat(state["image_return"])
            return sim
        if self.reduction == "sum":
            return state["similarity"]
        return state["similarity"] / state["total"]


class MultiScaleStructuralSimilarityIndexMeasure(Metric):
    """MS-SSIM."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        gaussian_kernel: bool = True,
        kernel_size: Union[int, Sequence[int]] = 11,
        sigma: Union[float, Sequence[float]] = 1.5,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        normalize: Optional[str] = "relu",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if reduction not in _VALID_REDUCTIONS:
            raise ValueError(f"Argument `reduction` must be one of {_VALID_REDUCTIONS}, but got {reduction}")
        if not isinstance(kernel_size, (Sequence, int)):
            raise ValueError("Argument `kernel_size` expected to be an sequence or an int")
        if not isinstance(betas, tuple) or not all(isinstance(b, float) for b in betas):
            raise ValueError("Argument `betas` is expected to be of a type tuple of floats.")
        if normalize is not None and normalize not in ("relu", "simple"):
            raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
        self.gaussian_kernel = gaussian_kernel
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.betas = betas
        self.normalize = normalize
        if reduction in ("none", None):
            self.add_state("similarity", [], dist_reduce_fx="cat")
        else:
            self.add_state("similarity", torch.zeros(()), dist_reduce_fx="sum")
            self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        preds, target = _ssim_check_inputs(self._tensor(preds), self._tensor(target))
        sim = _multiscale_ssim_update(preds, target, self.gaussian_kernel, self.sigma, self.kernel_size,
                                      self.data_range, self.k1, self.k2, self.betas, self.normalize)
        new = dict(state)
        if isinstance(state["similarity"], tuple):
            new["similarity"] = state["similarity"] + (sim,)
        else:
            new["similarity"] = state["similarity"] + sim.sum()
            new["total"] = state["total"] + sim.shape[0]
        return new

    def _compute(self, state: State) -> Tensor:
        if isinstance(state["similarity"], tuple):
            return dim_zero_cat(state["similarity"])
        if self.reduction == "sum":
            return state["similarity"]
        return state["similarity"] / state["total"]
