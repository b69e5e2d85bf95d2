"""Running (counterpart of ``torchmetrics_tpu/wrappers/running.py``).

The metric over the last ``window`` updates: each update's batch state is kept, at most ``window`` of them, and
``compute`` folds them with the base metric's ``merge_states``.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
    >>> from torchmetrics_tpu_torch.wrappers import Running
    >>> metric = Running(MeanSquaredError(device="cpu"), window=2)
    >>> for p, t in [(1.0, 1.5), (2.0, 2.0), (3.0, 3.5)]:
    ...     metric.update(torch.tensor([p]), torch.tensor([t]))
    >>> round(float(metric.compute()), 4)
    0.125
"""

from __future__ import annotations

from typing import Any, List

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


class Running(WrapperMetric):
    """The base metric over a sliding window of its last ``window`` updates; the base metric must merge its
    states (``full_state_update=False``)."""

    def __init__(self, base_metric: Metric, window: int = 5, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(f"Expected argument `base_metric` to be an instance of `Metric` but got {base_metric}")
        if not (isinstance(window, int) and window > 0):
            raise ValueError(f"Expected argument `window` to be a positive integer but got {window}")
        if base_metric.full_state_update:
            raise ValueError(
                f"Expected attribute `full_state_update` set to `False` but got {base_metric.full_state_update}"
            )
        super().__init__(base_metric, **kwargs)
        self.base_metric = base_metric
        self.window = window
        self._batch_states: List[State] = []

    def _push(self, *args: Any, **kwargs: Any) -> State:
        batch_state = self.base_metric.update_state(self.base_metric.init_state(), *args, **kwargs)
        self._batch_states.append(batch_state)
        if len(self._batch_states) > self.window:
            self._batch_states.pop(0)
        return batch_state

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._push(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        return self.base_metric.compute_state(self._push(*args, **kwargs))

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def compute(self) -> Any:
        if not self._batch_states:
            return self.base_metric.compute_state(self.base_metric.init_state())
        state = self._batch_states[0]
        for s in self._batch_states[1:]:
            state = self.base_metric.merge_states(state, s)
        return self.base_metric.compute_state(state)

    def reset(self) -> None:
        self._batch_states = []
        self.base_metric.reset()
