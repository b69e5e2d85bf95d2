"""MetricTracker (counterpart of ``torchmetrics_tpu/wrappers/tracker.py``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
    >>> from torchmetrics_tpu_torch.wrappers import MetricTracker
    >>> tracker = MetricTracker(BinaryAccuracy(device="cpu"))
    >>> for epoch in range(2):
    ...     _ = tracker.increment()
    ...     tracker.update(torch.tensor([0.8, 0.2, 0.9, 0.4]), torch.tensor([1, epoch, 1, 0]))
    >>> best, which = tracker.best_metric(return_step=True)
    >>> (round(float(best), 4), int(which))
    (1.0, 0)
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


def _best(values: Tensor, maximize: bool) -> Tuple[Tensor, int]:
    """The best step, as ``jnp.argmax``/``jnp.argmin`` pick it over the flattened values: the first NaN if there is
    one, else the first of tied extremes; the value read as JAX indexes, the index clamped to the first axis."""
    flat = values.reshape(-1)
    nan = torch.isnan(flat) if flat.is_floating_point() else torch.zeros_like(flat, dtype=torch.bool)
    hits = nan if bool(nan.any()) else flat == (flat.max() if maximize else flat.min())
    idx = int(hits.nonzero()[0, 0])
    return values[min(idx, values.shape[0] - 1)], idx


class MetricTracker(WrapperMetric):
    """A fresh copy of a metric (or collection) at each ``increment()``, the history kept."""

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool]] = True,
                 **kwargs: Any) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Metric arg need to be an instance of a torchmetrics_tpu_torch"
                f" `Metric` or `MetricCollection` but got {metric}"
            )
        if not isinstance(maximize, (bool, list)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list) and not all(isinstance(m, bool) for m in maximize):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        super().__init__(metric, **kwargs)
        self._base_metric = metric
        self.maximize = maximize
        self._increment_called = False
        self._history: List[Union[Metric, MetricCollection]] = []

    @property
    def n_steps(self) -> int:
        return len(self._history)

    def increment(self) -> None:
        """Start a new step with a fresh copy of the base metric."""
        self._increment_called = True
        m = deepcopy(self._base_metric)
        m.reset()
        self._history.append(m)

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called.")

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self._history[-1].update(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        return self._history[-1](*args, **kwargs)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self._history[-1].compute()

    def compute_all(self) -> Any:
        """Every step's result, stacked along a first axis (a dict of them for a collection)."""
        self._check_for_increment("compute_all")
        res = [m.compute() for m in self._history]
        if isinstance(self._base_metric, MetricCollection):
            keys = res[0].keys()
            return {k: torch.stack([torch.as_tensor(r[k]) for r in res], dim=0) for k in keys}
        return torch.stack([torch.as_tensor(r) for r in res], dim=0)

    def best_metric(
        self, return_step: bool = False
    ) -> Union[Tensor, Tuple[Tensor, int], Dict[str, Tensor], Tuple[Dict[str, Tensor], Dict[str, int]]]:
        """The best value (and the step it came at, with ``return_step``); a value that has none warns and gives
        None."""
        res = self.compute_all()
        if isinstance(res, dict):
            maximize = self.maximize if isinstance(self.maximize, list) else [self.maximize] * len(res)
            best, steps = {}, {}
            for (k, v), mx in zip(res.items(), maximize):
                try:
                    best[k], steps[k] = _best(v, mx)
                except (ValueError, TypeError, RuntimeError) as err:
                    rank_zero_warn(
                        f"Encountered the following error when trying to get the best metric for metric {k}: {err}",
                        UserWarning,
                    )
                    best[k], steps[k] = None, None
            return (best, steps) if return_step else best
        try:
            b, i = _best(res, bool(self.maximize))
        except (ValueError, TypeError, RuntimeError) as err:
            rank_zero_warn(f"Encountered the following error when trying to get the best metric: {err}", UserWarning)
            b, i = None, None
        return (b, i) if return_step else b

    def reset(self) -> None:
        """Reset the current step's metric."""
        if self._history:
            self._history[-1].reset()

    def reset_all(self) -> None:
        """Drop the whole history."""
        self._history = []
        self._increment_called = False
