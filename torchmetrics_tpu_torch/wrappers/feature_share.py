"""FeatureShare (counterpart of ``torchmetrics_tpu/wrappers/feature_share.py``).

A ``MetricCollection`` that swaps each member's feature network for one shared, memoized network, so that FID, KID
and IS run one InceptionV3 forward a batch. The port's generative metrics hold their network as ``inception``:
share it with ``feature_attr="inception"`` (the default, ``"feature_network"``, is the JAX package's, and no
generative metric of either package has such an attribute).

:class:`NetworkCache` keys an input by its shape, dtype and a strided sample of 16 of its values, as the JAX
package does: two batches of one shape and dtype whose 16 sampled values agree share an entry. On the card only
those 16 values are read to the host.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.image import FrechetInceptionDistance, KernelInceptionDistance
    >>> from torchmetrics_tpu_torch.wrappers import FeatureShare
    >>> fs = FeatureShare([FrechetInceptionDistance(feature=64, device="cpu"),
    ...                    KernelInceptionDistance(feature=64, subset_size=4, device="cpu")], feature_attr="inception")
    >>> fs["FrechetInceptionDistance"].inception is fs["KernelInceptionDistance"].inception
    True
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.core.metric import Metric


def _sample_key(x: Any) -> tuple:
    """``(shape, dtype, bytes of 16 values strided over x)``, the JAX package's fingerprint of an input."""
    if isinstance(x, torch.Tensor):
        flat = x.detach().reshape(-1)
        sample = flat[:: max(1, flat.numel() // 16)][:16].cpu().numpy()
        return tuple(x.shape), str(x.dtype), sample.tobytes()
    arr = np.asarray(x)
    sample = arr.reshape(-1)[:: max(1, arr.size // 16)][:16]
    return arr.shape, str(arr.dtype), sample.tobytes()


class NetworkCache:
    """Memoize a feature network on its most recent ``max_size`` inputs (the oldest entry goes first)."""

    def __init__(self, network: Callable, max_size: int = 8) -> None:
        self.network = network
        self.max_size = max_size
        self._cache: Dict[Any, Any] = {}

    def _key(self, *args: Any) -> Any:
        return tuple(_sample_key(a) if hasattr(a, "shape") else a for a in args)

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        key = self._key(*args)
        if key not in self._cache:
            if len(self._cache) >= self.max_size:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = self.network(*args, **kwargs)
        return self._cache[key]


class FeatureShare(MetricCollection):
    """One feature network shared by every member metric, which must each hold it as ``feature_attr``."""

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        max_cache_size: Optional[int] = None,
        feature_attr: str = "feature_network",
        **kwargs: Any,
    ) -> None:
        super().__init__(metrics, compute_groups=False, **kwargs)
        if max_cache_size is None:
            max_cache_size = len(self)
        if not isinstance(max_cache_size, int):
            raise TypeError(f"max_cache_size should be an integer, but got {max_cache_size}")
        self._feature_attr = feature_attr

        try:
            first = next(iter(self.values()))
            shared = NetworkCache(getattr(first, feature_attr), max_size=max_cache_size)
        except AttributeError as err:
            raise AttributeError(
                "Tried to extract the network to share from the first metric, but it did not have a"
                f" `{feature_attr}` attribute. Please make sure that the metric has an attribute with that name,"
                " else it cannot be shared."
            ) from err
        for m in self.values():
            if not hasattr(m, feature_attr):
                raise AttributeError(
                    f"Tried to set the cached network to all metrics, but the metric {m.__class__.__name__} did not"
                    f" have a `{feature_attr}` attribute."
                )
            setattr(m, feature_attr, shared)
