"""BootStrapper (counterpart of ``torchmetrics_tpu/wrappers/bootstrapping.py``).

Each replicate is a copy of the base metric, updated on the batch resampled by indices drawn on the host from a
``numpy.random.default_rng(seed)`` by the JAX package's sampler, in its order: the replicates see the same rows
in both packages. A replicate's indices reach each input's device in one copy, and a gather there builds its batch.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
    >>> from torchmetrics_tpu_torch.wrappers import BootStrapper
    >>> metric = BootStrapper(MeanSquaredError(device="cpu"), num_bootstraps=5, seed=42)
    >>> metric.update(torch.tensor([1.0, 2.0, 3.0, 4.0]), torch.tensor([1.0, 2.5, 3.0, 4.5]))
    >>> sorted(metric.compute().keys())
    ['mean', 'std']
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


def _bootstrap_sampler(size: int, sampling_strategy: str = "poisson", rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Resampled indices of one replicate: each row repeated a Poisson(1) number of times, or ``size`` uniform
    draws with replacement."""
    rng = rng or np.random.default_rng()
    if sampling_strategy == "poisson":
        counts = rng.poisson(1.0, size)
        return np.repeat(np.arange(size), counts)
    if sampling_strategy == "multinomial":
        return rng.integers(0, size, size)
    raise ValueError("Unknown sampling strategy")


def _resampled(x: Any, size: int, idx: np.ndarray, on_device: Dict[torch.device, Tensor]) -> Any:
    """``x[idx]`` for an input of ``size`` rows (the indices copied to its device once), else ``x``."""
    if not (hasattr(x, "shape") and x.ndim > 0 and x.shape[0] == size):
        return x
    if not isinstance(x, Tensor):
        return x[idx]
    if x.device not in on_device:
        on_device[x.device] = torch.from_numpy(idx).to(x.device)
    return x[on_device[x.device]]


class BootStrapper(WrapperMetric):
    """``num_bootstraps`` replicates of ``base_metric`` on resampled batches; ``compute`` gives their ``mean``,
    ``std`` (with Bessel's correction), linear ``quantile`` and ``raw`` values."""

    full_state_update = True

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Tensor]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of torchmetrics_tpu_torch.Metric but received {base_metric}"
            )
        super().__init__(base_metric, **kwargs)
        self.metrics = [deepcopy(base_metric) for _ in range(num_bootstraps)]
        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        allowed = ("poisson", "multinomial")
        if sampling_strategy not in allowed:
            raise ValueError(f"Expected argument ``sampling_strategy`` to be one of {allowed} but received {sampling_strategy}")
        self.sampling_strategy = sampling_strategy
        self._rng = np.random.default_rng(seed)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Resample the batch for each replicate and update it; an empty batch updates each replicate as it is."""
        args_sizes = [a.shape[0] for a in args if hasattr(a, "shape") and a.ndim > 0]
        size = args_sizes[0] if args_sizes else 0
        for metric in self.metrics:
            if size == 0:
                metric.update(*args, **kwargs)
                continue
            idx = _bootstrap_sampler(size, self.sampling_strategy, self._rng)
            on_device: Dict[torch.device, Tensor] = {}
            new_args = [_resampled(a, size, idx, on_device) for a in args]
            new_kwargs = {k: _resampled(v, size, idx, on_device) for k, v in kwargs.items()}
            if idx.shape[0] > 0:
                metric.update(*new_args, **new_kwargs)

    def compute(self) -> Dict[str, Tensor]:
        computed_vals = torch.stack([torch.as_tensor(m.compute()) for m in self.metrics], dim=0)
        output: Dict[str, Tensor] = {}
        if self.mean:
            output["mean"] = computed_vals.mean(dim=0)
        if self.std:
            output["std"] = computed_vals.std(dim=0, correction=1)
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=computed_vals.dtype, device=computed_vals.device)
            output["quantile"] = torch.quantile(computed_vals, q, dim=0)
        if self.raw:
            output["raw"] = computed_vals
        return output

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        self.update(*args, **kwargs)
        return self.compute()

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        return self.forward(*args, **kwargs)

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
