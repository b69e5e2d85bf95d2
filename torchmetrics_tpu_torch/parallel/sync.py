"""The metric-state sync backend (counterpart of ``torchmetrics_tpu/parallel/sync.py``).

The JAX package syncs a state inside ``shard_map`` over a mesh axis (ICI)
and across hosts with ``process_allgather`` (DCN). The port has one path:
eager collectives on ``torch.distributed``'s default process group, which
is already cross-process. Each rank runs its update on its own shard and
:func:`sync_state` combines the states, one collective per (dtype, op)
bucket (:mod:`.coalesce`). Without an initialized process group the world
is one rank and a sync only applies the reductions to it (a MEAN of an
int32 leaf still comes back as float32).

:func:`sharded_update` and :func:`sharded_collection_update` take a
``sync_policy``: a deferring one folds this rank's batches into its own
running state and syncs only every ``k`` steps or at compute (through
:func:`~torchmetrics_tpu_torch.parallel.coalesce.cadence_stepper`).

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
from torchmetrics_tpu_torch.parallel.coalesce import (
    CompressionConfig,
    SyncPolicy,
    _check_divergence_options,
    _own_sync,
    cadence_stepper,
    coalesced_metric_sync,
    coalesced_sync_state,
)

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


def _sync_states_with(metric: Any, state: State, compression: Optional[CompressionConfig]) -> State:
    """``metric.sync_states``, with the compression only where it is the leaf-wise sync: a metric that
    overrides it keeps its own exact aggregation."""
    if compression is not None and not _own_sync(metric):
        return metric.sync_states(state, compression=compression)
    return metric.sync_states(state)


def sharded_update(
    metric: Any,
    *inputs: Any,
    sync_policy: Optional[SyncPolicy] = None,
    verify_consistency: bool = False,
    on_divergence: str = "raise",
    **kwargs: Any,
) -> Optional[State]:
    """One metric update on this rank's shard of the batch, then the sync:
    the per-rank analogue of JAX's ``sharded_update``, which splits the batch
    over a mesh inside one program. Returns the synced state, equal on every
    rank (a sharded leaf: this rank's block).

    With a deferring ``sync_policy`` (``SyncPolicy(every_n_steps=k)`` or
    ``at_compute=True``) repeated calls accumulate on each rank and the
    coalesced sync runs on sync steps only: the call returns the cumulative
    synced state on those and ``None`` on deferred ones; finish with
    :func:`~torchmetrics_tpu_torch.parallel.coalesce.flush_sync`. A policy's
    ``compression`` applies to the leaf-wise sync. ``verify_consistency=True``
    and ``on_divergence="quarantine"`` need the resilience slice, not ported
    yet, and raise ``NotImplementedError``.
    """
    _check_divergence_options(verify_consistency, on_divergence)
    compression = sync_policy.compression_config if sync_policy is not None else None
    if sync_policy is not None and sync_policy.defers:
        if kwargs:
            raise ValueError(
                "sharded_update(sync_policy=...) needs positional inputs: the cadence "
                "stepper folds positional batches only, as the JAX package's does"
            )
        return cadence_stepper(metric, sync_policy).update(*inputs)
    return _sync_states_with(metric, metric.update_state(metric.init_state(), *inputs, **kwargs), compression)


def sharded_collection_update(
    collection: Any,
    *inputs: Any,
    sync_policy: Optional[SyncPolicy] = None,
    verify_consistency: bool = False,
    on_divergence: str = "raise",
) -> Optional[Dict[str, State]]:
    """Every compute-group leader of a ``MetricCollection`` updates on this rank's batch and the whole
    collection syncs in ONE cross-leader bucket plan. Returns ``{leader: synced state}`` for
    ``collection.compute_states``.

    ``sync_policy`` (by default the collection's ``sync_policy=``) defers the
    sync as :func:`sharded_update`'s does: ``None`` on deferred steps, the
    cumulative states on sync steps. Leaders with list (cat) states are
    refused: defer their gather with ``DeferredRaggedSync``.
    """
    _check_divergence_options(verify_consistency, on_divergence)
    leaders = tuple(members[0] for members in collection._functional_groups().values())
    listy = [name for name in leaders if any(isinstance(v, tuple) for v in collection[name]._defaults.values())]
    if listy:
        raise ValueError(
            f"sharded_collection_update syncs fixed-size (psum-family) states in one plan; "
            f"leaders {listy} hold list (cat) states, which grow per step. "
            "Update those eagerly and defer their gather to compute with DeferredRaggedSync."
        )
    if sync_policy is None:
        sync_policy = getattr(collection, "_sync_policy", None)
    if sync_policy is not None and sync_policy.defers:
        return cadence_stepper(collection, sync_policy).update(*inputs)
    compression = sync_policy.compression_config if sync_policy is not None else None
    metrics = [collection[name] for name in leaders]
    states = [m.update_state(m.init_state(), *inputs) for m in metrics]
    return dict(zip(leaders, coalesced_metric_sync(metrics, states, compression=compression)))


def reduce(x: Tensor, reduction: str = "elementwise_mean") -> Tensor:
    """Reduce a tensor: ``elementwise_mean``, ``sum`` or ``none``."""
    if reduction == "elementwise_mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    if reduction in ("none", None):
        return x
    raise ValueError("Reduction parameter unknown.")
