"""PSNR and PSNR-B metric classes (counterpart of ``torchmetrics_tpu/image/psnr.py``).

PSNR keeps float32 ``sum_squared_error`` and an int32 pixel count ``total``
(sum-reduced), or cat lists of both when ``dim`` is given, and, with no data
range, the target's running ``min_target`` / ``max_target``.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.image import PeakSignalNoiseRatio
    >>> metric = PeakSignalNoiseRatio(data_range=1.0, device="cpu")
    >>> metric.update(torch.full((1, 3, 8, 8), 0.4), torch.full((1, 3, 8, 8), 0.5))
    >>> round(float(metric.compute()), 4)
    20.0
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.image.psnr import _psnr_compute, _psnr_update, _psnrb_compute, _psnrb_update
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class PeakSignalNoiseRatio(Metric):
    """PSNR; the data range, when not given, from the target's extremes."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        base: float = 10.0,
        reduction: Optional[str] = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
        self.base = base
        self.reduction = reduction
        self.dim = (dim,) if isinstance(dim, int) else dim
        self.clamp_range: Optional[Tuple[float, float]] = None
        if dim is None:
            self.add_state("sum_squared_error", torch.zeros(()), dist_reduce_fx="sum", value_range=(0.0, float("inf")))
            # pixels, int32: exact to 2**31 where float32 stops at 2**24
            self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum",
                           value_range=(0.0, float("inf")))
        else:
            self.add_state("sum_squared_error", [], dist_reduce_fx="cat")
            self.add_state("total", [], dist_reduce_fx="cat")
        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            self.add_state("min_target", torch.tensor(float("inf")), dist_reduce_fx="min")
            self.add_state("max_target", torch.tensor(float("-inf")), dist_reduce_fx="max")
        elif isinstance(data_range, tuple):
            self.data_range = torch.tensor(float(data_range[1] - data_range[0]), device=self.device)
            self.clamp_range = (float(data_range[0]), float(data_range[1]))
        else:
            self.data_range = torch.tensor(float(data_range), device=self.device)

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        preds, target = self._tensor(preds), self._tensor(target)
        if self.clamp_range is not None:
            preds = torch.clamp(preds, self.clamp_range[0], self.clamp_range[1])
            target = torch.clamp(target, self.clamp_range[0], self.clamp_range[1])
        sse, n = _psnr_update(preds, target, dim=self.dim)
        new = dict(state)
        if self.dim is None:
            new["sum_squared_error"] = state["sum_squared_error"] + sse
            new["total"] = state["total"] + n.to(state["total"].dtype)
            if self.data_range is None:  # the range from the target only
                new["min_target"] = torch.minimum(state["min_target"], target.min())
                new["max_target"] = torch.maximum(state["max_target"], target.max())
        else:
            new["sum_squared_error"] = state["sum_squared_error"] + (sse.reshape(-1),)
            new["total"] = state["total"] + (n.reshape(-1),)
        return new

    def _compute(self, state: State) -> Tensor:
        rng = self.data_range if self.data_range is not None else state["max_target"] - state["min_target"]
        if self.dim is None:
            sse, total = state["sum_squared_error"], state["total"]
        else:
            sse, total = dim_zero_cat(state["sum_squared_error"]), dim_zero_cat(state["total"])
        return _psnr_compute(sse, total, rng, base=self.base, reduction=self.reduction)


class PeakSignalNoiseRatioWithBlockedEffect(Metric):
    """PSNR-B, grayscale only."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, block_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(block_size, int) or block_size < 1:
            raise ValueError("Argument `block_size` should be a positive integer")
        self.block_size = block_size
        self.add_state("sum_squared_error", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("bef", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("data_range", torch.zeros(()), dist_reduce_fx="max")

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        preds, target = self._tensor(preds), self._tensor(target)
        sse, bef, n = _psnrb_update(preds, target, block_size=self.block_size)
        return {
            "sum_squared_error": state["sum_squared_error"] + sse,
            "total": state["total"] + n,
            "bef": state["bef"] + bef,
            "data_range": torch.maximum(state["data_range"], target.max() - target.min()),
        }

    def _compute(self, state: State) -> Tensor:
        return _psnrb_compute(state["sum_squared_error"], state["bef"], state["total"], state["data_range"])
