"""MultioutputWrapper (counterpart of ``torchmetrics_tpu/wrappers/multioutput.py``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
    >>> from torchmetrics_tpu_torch.wrappers import MultioutputWrapper
    >>> metric = MultioutputWrapper(MeanSquaredError(device="cpu"), num_outputs=2)
    >>> metric.update(torch.tensor([[1.0, 2.0], [2.0, 4.0]]), torch.tensor([[1.0, 3.0], [2.0, 4.0]]))
    >>> [round(float(v), 4) for v in metric.compute()]
    [0.0, 0.5]
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, List, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


def _keep_rows(args: List[Tensor]) -> Tensor:
    """The rows where no input is NaN. The JAX package reduces the mask reshaped to two dims over its original
    dims past the first: an output slice of three or more dims raises ``ValueError`` there, and here too."""
    nan_mask = torch.zeros(args[0].shape, dtype=torch.bool, device=args[0].device)
    for v in args:
        nan_mask = nan_mask | torch.isnan(v)
    axes = tuple(range(1, nan_mask.ndim)) or (1,)
    if max(axes) >= 2:
        raise ValueError(f"axis {max(axes)} is out of bounds for array of dimension 2")
    return ~nan_mask.reshape(nan_mask.shape[0], -1).any(dim=1)


def _squeeze(x: Tensor, dim: int) -> Tensor:
    """``jnp.squeeze(x, axis=dim)``: raises where that dim is not of size one (``torch.squeeze`` leaves it)."""
    if x.shape[dim] != 1:
        raise ValueError(
            "cannot select an axis to squeeze out which has size not equal to one, "
            f"got shape={tuple(x.shape)} and dimensions=({dim % x.ndim},)"
        )
    return x.squeeze(dim)


class MultioutputWrapper(WrapperMetric):
    """A copy of the base metric for each output, each fed its slice of the inputs along ``output_dim``; rows with
    a NaN in any input are dropped first when ``remove_nans``."""

    is_differentiable = False

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(base_metric, **kwargs)
        self.metrics = [deepcopy(base_metric) for _ in range(num_outputs)]
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _get_args_kwargs_by_output(self, *args: Tensor, **kwargs: Tensor) -> List[Tuple[list, dict]]:
        args = [torch.as_tensor(a) for a in args]
        kwargs = {k: torch.as_tensor(v) for k, v in kwargs.items()}
        args_kwargs_by_output = []
        for i in range(len(self.metrics)):
            index = torch.tensor([i])
            selected_args = [torch.index_select(a, self.output_dim, index.to(a.device)) for a in args]
            selected_kwargs = {k: torch.index_select(v, self.output_dim, index.to(v.device)) for k, v in kwargs.items()}
            if self.remove_nans:
                all_vals = list(selected_args) + list(selected_kwargs.values())
                if all_vals:
                    keep = _keep_rows(all_vals)
                    selected_args = [a[keep] for a in selected_args]
                    selected_kwargs = {k: v[keep] for k, v in selected_kwargs.items()}
            if self.squeeze_outputs:
                selected_args = [_squeeze(a, self.output_dim) for a in selected_args]
                selected_kwargs = {k: _squeeze(v, self.output_dim) for k, v in selected_kwargs.items()}
            args_kwargs_by_output.append((selected_args, selected_kwargs))
        return args_kwargs_by_output

    def update(self, *args: Any, **kwargs: Any) -> None:
        for (sel_args, sel_kwargs), metric in zip(self._get_args_kwargs_by_output(*args, **kwargs), self.metrics):
            metric.update(*sel_args, **metric._filter_kwargs(**sel_kwargs))

    def compute(self) -> Tensor:
        return torch.stack([m.compute() for m in self.metrics], dim=0)

    # ------------------------------------------------- functional state surface
    # state = {"<output index>": child state}; the NaN rows' mask depends on the data, so this surface takes
    # ``remove_nans=False`` only, as the JAX package's (where jit and shard_map cannot trace it).

    def init_state(self) -> dict:
        return {str(i): m.init_state() for i, m in enumerate(self.metrics)}

    def update_state(self, state: dict, *args: Any, **kwargs: Any) -> dict:
        if self.remove_nans:
            raise ValueError(
                "MultioutputWrapper's functional state path cannot drop NaN rows — the mask "
                "is data-dependent, which jit/shard_map cannot trace. Construct the wrapper "
                "with `remove_nans=False` (or use the eager update())."
            )
        out = {}
        pairs = zip(self._get_args_kwargs_by_output(*args, **kwargs), self.metrics)
        for i, ((sel_args, sel_kwargs), metric) in enumerate(pairs):
            out[str(i)] = metric.update_state(state[str(i)], *sel_args, **metric._filter_kwargs(**sel_kwargs))
        return out

    def compute_state(self, state: dict) -> Tensor:
        return torch.stack([m.compute_state(state[str(i)]) for i, m in enumerate(self.metrics)], dim=0)

    def merge_states(self, a: dict, b: dict) -> dict:
        return {str(i): m.merge_states(a[str(i)], b[str(i)]) for i, m in enumerate(self.metrics)}

    def sync_states(self, state: dict, compression: Any = None, weight: Any = None) -> dict:
        return {str(i): m.sync_states(state[str(i)], compression, weight) for i, m in enumerate(self.metrics)}

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        results = []
        for (sel_args, sel_kwargs), metric in zip(self._get_args_kwargs_by_output(*args, **kwargs), self.metrics):
            results.append(metric(*sel_args, **metric._filter_kwargs(**sel_kwargs)))
        if results[0] is None:
            return None
        return torch.stack(results, dim=0)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
