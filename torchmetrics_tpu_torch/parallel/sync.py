"""The metric-state sync backend (counterpart of ``torchmetrics_tpu/parallel/sync.py``).

The JAX package syncs a state inside ``shard_map`` over a mesh axis (ICI)
and across hosts with ``process_allgather`` (DCN). The port has one path:
eager collectives on ``torch.distributed``'s default process group, which
is already cross-process. Each rank runs its update on its own shard and
:func:`sync_state` combines the states, one collective per (dtype, op)
bucket (:mod:`.coalesce`). Without an initialized process group the world
is one rank and a sync only applies the reductions to it (a MEAN of an
int32 leaf still comes back as float32).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
    >>> from torchmetrics_tpu_torch.parallel import sharded_update
    >>> metric = MulticlassAccuracy(num_classes=3, average="micro", device="cpu")
    >>> state = sharded_update(metric, torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 2, 2]))
    >>> round(float(metric.compute_state(state)), 4)  # one rank: this rank's shard is the batch
    0.75
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Union

from torch import Tensor

from torchmetrics_tpu_torch.core.reductions import Reduce, gather_all_tensors, world_size
from torchmetrics_tpu_torch.parallel.coalesce import coalesced_sync_state

State = Dict[str, Any]


def distributed_available() -> bool:
    """True when a process group with more than one rank is up."""
    return world_size() > 1


def sync_state(
    state: State,
    reductions: Mapping[str, Union[Reduce, Callable]],
    compression: Optional[Any] = None,
) -> State:
    """Combine every leaf of ``state`` over the ranks under its reduction
    table, one ``all_reduce`` per (dtype, op) bucket; the reserved ``_n``
    counter rides the int32 sum bucket."""
    return coalesced_sync_state(state, reductions, compression=compression)


def host_sync_state(
    state: State,
    reductions: Mapping[str, Union[Reduce, Callable]],
    compression: Optional[Any] = None,
) -> State:
    """:func:`sync_state`: ``torch.distributed`` is already cross-process,
    so the port's host sync and in-step sync are one path."""
    return sync_state(state, reductions, compression=compression)


def gather_all_arrays(value: Tensor, group: Any = None) -> List[Tensor]:
    """Every rank's copy of ``value``, in rank order.

    Shapes may differ: each copy is padded to the largest size of each
    dimension, gathered once and trimmed back, as the reference's
    ``gather_all_tensors`` does. As in the JAX package, only the default
    group is supported: a non-``None`` ``group`` raises.
    """
    if group is not None:
        raise ValueError(
            "gather_all_arrays(group=...) is not supported: the gather spans the default "
            "process group. Pass group=None and filter the returned per-rank list instead."
        )
    return gather_all_tensors(value)


def sharded_update(
    metric: Any,
    *inputs: Any,
    sync_policy: Optional[Any] = None,
    verify_consistency: bool = False,
    **kwargs: Any,
) -> State:
    """One metric update on this rank's shard of the batch, then the sync:
    the per-rank analogue of JAX's ``sharded_update``, which splits the batch
    over a mesh inside one program. Returns the synced state, equal on every
    rank. ``sync_policy`` and ``verify_consistency`` are not ported yet."""
    if sync_policy is not None or verify_consistency:
        raise NotImplementedError("sharded_update(sync_policy=..., verify_consistency=True) is not ported yet")
    return metric.sync_states(metric.update_state(metric.init_state(), *inputs, **kwargs))


def reduce(x: Tensor, reduction: str = "elementwise_mean") -> Tensor:
    """Reduce a tensor: ``elementwise_mean``, ``sum`` or ``none``."""
    if reduction == "elementwise_mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    if reduction in ("none", None):
        return x
    raise ValueError("Reduction parameter unknown.")
