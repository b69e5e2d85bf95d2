"""Abstract wrapper base (counterpart of ``torchmetrics_tpu/wrappers/abstract.py``)."""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.core.metric import Metric


def _device_of(wrapped: Any) -> Optional[torch.device]:
    """The device of a wrapped metric, of the first metric of a collection or dict of them, or None."""
    if isinstance(wrapped, Metric):
        return wrapped.device
    if isinstance(wrapped, dict):
        return next((d for d in map(_device_of, wrapped.values()) if d is not None), None)
    return None


class WrapperMetric(Metric):
    """Base of the metrics that wrap other metrics; the wrapper itself does not sync (``sync_on_compute`` is False,
    and True is refused as the base refuses it).

    The wrapper lives on ``device``, by default the wrapped metric's (the first metric's of a collection).
    """

    def __init__(self, wrapped: Any = None, **kwargs: Any) -> None:
        if kwargs.pop("sync_on_compute", False):
            raise ValueError("Metric arguments ['sync_on_compute'] are not supported by the PyTorch port yet")
        if kwargs.get("device") is None:
            kwargs["device"] = _device_of(wrapped)
        super().__init__(**kwargs)
        self.sync_on_compute = False

    def _update(self, state, *args: Any, **kwargs: Any):
        raise NotImplementedError

    def _compute(self, state):
        raise NotImplementedError
