"""Per-state reduction specs (counterpart of ``torchmetrics_tpu/core/reductions.py``).

The ``dist_reduce_fx`` given to ``Metric.add_state`` says how two copies of a
state leaf combine. This slice ports the local pairwise merge
(``merge_leaf``), which ``forward`` accumulation and checkpoint joining use.
List ("cat") states are tuples of tensors.
"""

from __future__ import annotations

from enum import Enum
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor


class Reduce(str, Enum):
    SUM = "sum"
    MEAN = "mean"
    MAX = "max"
    MIN = "min"
    CAT = "cat"
    NONE = "none"


ReduceFx = Union[Reduce, str, Callable, None]
ListState = Tuple[Tensor, ...]


def canonical_reduce(fx: ReduceFx) -> Union[Reduce, Callable]:
    """Normalize a user-provided ``dist_reduce_fx`` into a :class:`Reduce` or callable."""
    if fx is None:
        return Reduce.NONE
    if isinstance(fx, Reduce):
        return fx
    if callable(fx):
        return fx
    try:
        return Reduce(str(fx))
    except ValueError:
        raise ValueError(
            f"`dist_reduce_fx` must be one of {[r.value for r in Reduce]}, a callable, or None; got {fx!r}"
        ) from None


def reduce_identity(reduce: Any, dtype: torch.dtype) -> Optional[Tensor]:
    """The absorbing identity of a canonical reduce, as a ``dtype`` scalar.

    ``merge(x, identity) == x`` for the elementwise families: 0 for SUM and
    MEAN, -inf/+inf for MAX/MIN (``iinfo.min``/``iinfo.max`` on integer
    leaves, False/True on bool leaves). CAT, NONE and callables have no
    elementwise identity: ``None``.
    """
    if not isinstance(reduce, Reduce):
        return None
    if reduce in (Reduce.SUM, Reduce.MEAN):
        return torch.zeros((), dtype=dtype)
    if reduce in (Reduce.MAX, Reduce.MIN):
        if dtype == torch.bool:
            return torch.tensor(reduce is Reduce.MIN, dtype=dtype)
        if not dtype.is_floating_point and not dtype.is_complex:
            info = torch.iinfo(dtype)
            return torch.tensor(info.min if reduce is Reduce.MAX else info.max, dtype=dtype)
        return torch.tensor(-float("inf") if reduce is Reduce.MAX else float("inf"), dtype=dtype)
    return None


def merge_leaf(
    reduce: Union[Reduce, Callable],
    a: Union[Tensor, ListState],
    b: Union[Tensor, ListState],
    n_a: Optional[Tensor] = None,
    n_b: Optional[Tensor] = None,
) -> Union[Tensor, ListState]:
    """Pairwise merge of two state leaves under the given reduction.

    For ``MEAN`` the merge is the running mean weighted by update counts.
    """
    if callable(reduce) and not isinstance(reduce, Reduce):
        return reduce(torch.stack([a, b]))
    if reduce == Reduce.SUM:
        return a + b
    if reduce == Reduce.MEAN:
        if n_a is None or n_b is None:
            return (a + b) / 2.0
        return (a * n_a + b * n_b) / torch.clamp(n_a + n_b, min=1)
    if reduce == Reduce.MAX:
        return torch.maximum(a, b)
    if reduce == Reduce.MIN:
        return torch.minimum(a, b)
    if reduce in (Reduce.CAT, Reduce.NONE):
        return tuple(a) + tuple(b)
    raise ValueError(f"Unknown reduction {reduce}")
