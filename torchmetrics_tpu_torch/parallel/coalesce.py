"""Collective coalescing: the exact sync planner (counterpart of ``torchmetrics_tpu/parallel/coalesce.py``).

Per-leaf sync pays one collective per state leaf. The planner instead
flattens every psum-family leaf (SUM, MEAN, MAX, MIN) of one or many states
into one buffer per ``(dtype, op)`` bucket and issues ONE ``all_reduce`` per
bucket. MEAN rides the sum bucket and is divided by the world size after.
The reserved ``_n`` counter is summed in the int32 bucket. Bucket order is
sorted by ``(dtype, op)`` and slot order follows entry and table order, as
in the JAX planner, so every rank issues the same collectives in the same
order.

Sketch leaves (:class:`~torchmetrics_tpu_torch.core.reductions.SketchReduce`)
with a ``bucket_op`` ride the fused dtype bucket of that op, as SUM, MAX and
MIN leaves do. Leaves that cannot share a bucket pass through
:func:`~torchmetrics_tpu_torch.core.reductions.sync_leaf` one by one: cat,
none and callable reductions, structural sketches (one fixed-shape gather
each, no shape exchange), list states, and integer MEAN leaves (their mean is
a float, and a bucket must not change a dtype).

This slice ports the exact planner only. Compression, sharded buckets, the
quarantine ``weight``, ``SyncPolicy``, ``SyncStepper`` and ``SyncAdvisor``
wait for a later slice: a non-default argument raises.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.core.reductions import Reduce
    >>> from torchmetrics_tpu_torch.parallel.coalesce import build_sync_plan
    >>> state = {"tp": torch.zeros(5), "fp": torch.zeros(5), "lo": torch.zeros(()),
    ...          "_n": torch.zeros((), dtype=torch.int32)}
    >>> table = {"tp": Reduce.SUM, "fp": Reduce.SUM, "lo": Reduce.MIN}
    >>> plan = build_sync_plan([(table, state)])
    >>> [(b.dtype, b.op, len(b.slots)) for b in plan.buckets]
    [('float32', 'min', 1), ('float32', 'sum', 2), ('int32', 'sum', 1)]
    >>> plan.n_collectives  # 3 buckets instead of 4 per-leaf collectives
    3
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.core.reductions import (
    Reduce,
    SketchReduce,
    all_reduce,
    canonical_reduce,
    sync_leaf,
    world_size,
)

State = Dict[str, Any]

_N = "_n"

#: reductions that are one elementwise all-reduce and can share a bucket
_PSUM_FAMILY = (Reduce.SUM, Reduce.MEAN, Reduce.MAX, Reduce.MIN)
_OP_OF = {Reduce.SUM: "sum", Reduce.MEAN: "sum", Reduce.MAX: "max", Reduce.MIN: "min"}


def dtype_name(dtype: torch.dtype) -> str:
    """``"float32"`` for ``torch.float32``: the JAX planner's bucket key, so buckets sort alike."""
    return str(dtype).replace("torch.", "")


@dataclass(frozen=True)
class _Slot:
    """One leaf's place in a bucket."""

    entry: int  # index into the entries/states sequence
    name: str
    shape: Tuple[int, ...]
    size: int
    mean: bool  # a MEAN leaf riding the sum bucket: divided by the world size after


@dataclass(frozen=True)
class Bucket:
    """All same-``(dtype, op)`` psum-family leaves fused into one ``all_reduce``."""

    dtype: str
    op: str  # "sum" | "min" | "max"
    slots: Tuple[_Slot, ...]

    @property
    def size(self) -> int:
        return sum(s.size for s in self.slots)

    @property
    def nbytes(self) -> int:
        return self.size * torch.empty((), dtype=getattr(torch, self.dtype)).element_size()


@dataclass(frozen=True)
class SyncPlan:
    """Static bucketing of one or many states under their reduction tables."""

    buckets: Tuple[Bucket, ...]
    #: ``(entry, name, reduce)`` of the leaves synced one by one
    passthrough: Tuple[Tuple[int, str, Any], ...]
    n_entries: int
    #: data collectives of the passthrough leaves
    n_passthrough_collectives: int
    #: shape exchanges that the passthrough gathers make before their data
    n_shape_exchanges: int

    @property
    def n_collectives(self) -> int:
        """Data collectives one sync under this plan launches (JAX's count model).

        A gathered leaf also makes one small shape exchange first
        (:attr:`n_shape_exchanges`); a list state is gathered once where JAX
        gathers each of its elements.
        """
        return len(self.buckets) + self.n_passthrough_collectives

    def bucket_bytes(self) -> Dict[str, int]:
        """``{"dtype/op": bytes}`` per bucket."""
        return {f"{b.dtype}/{b.op}": b.nbytes for b in self.buckets}


def _reduce_for(name: str, reductions: Mapping[str, Any]) -> Any:
    if name == _N:  # the reserved counter is always summed
        return Reduce.SUM
    try:
        return reductions[name]
    except KeyError:
        raise KeyError(
            f"state leaf {name!r} has no entry in the reduction table "
            f"(known: {sorted(reductions)}) and is not a reserved counter"
        ) from None


def _unported(**options: Any) -> None:
    given = sorted(k for k, v in options.items() if v is not None)
    if given:
        raise NotImplementedError(f"{given} of the JAX sync planner are not ported yet: pass None")


def build_sync_plan(
    entries: Sequence[Tuple[Mapping[str, Any], Mapping[str, Any]]],
    compression: Optional[Any] = None,
    shardings: Optional[Any] = None,
) -> SyncPlan:
    """Plan one coalesced sync over ``entries`` = [(reduction table, state), ...].

    Several entries (one per compute-group leader) share buckets. Buckets
    sort by ``(dtype, op)``; slots follow entry and table order.
    """
    _unported(compression=compression, shardings=shardings)
    groups: Dict[Tuple[str, str], List[_Slot]] = {}
    passthrough: List[Tuple[int, str, Any]] = []
    n_pass = n_shapes = 0
    for e, (reductions, state) in enumerate(entries):
        for name, value in state.items():
            reduce = canonical_reduce(_reduce_for(name, reductions))
            if isinstance(value, tuple):
                passthrough.append((e, name, reduce))
                per_item = reduce == Reduce.NONE
                n_pass += len(value) if per_item else 1
                n_shapes += len(value) if per_item else 1
                continue
            if isinstance(reduce, SketchReduce):
                if reduce.bucket_op is None:  # structural: one fixed-shape gather and the combine
                    passthrough.append((e, name, reduce))
                    n_pass += reduce.n_sync_gathers
                    continue
                slot = _Slot(entry=e, name=name, shape=tuple(value.shape), size=value.numel(), mean=False)
                groups.setdefault((dtype_name(value.dtype), reduce.bucket_op), []).append(slot)
                continue
            gathered = not isinstance(reduce, Reduce) or reduce not in _PSUM_FAMILY
            int_mean = reduce == Reduce.MEAN and not value.dtype.is_floating_point
            if gathered or int_mean:
                passthrough.append((e, name, reduce))
                n_pass += 1
                n_shapes += 1 if gathered else 0
                continue
            shape = tuple(value.shape)
            slot = _Slot(entry=e, name=name, shape=shape, size=value.numel(), mean=reduce == Reduce.MEAN)
            groups.setdefault((dtype_name(value.dtype), _OP_OF[reduce]), []).append(slot)
    buckets = tuple(Bucket(dtype=dt, op=op, slots=tuple(slots)) for (dt, op), slots in sorted(groups.items()))
    return SyncPlan(
        buckets=buckets,
        passthrough=tuple(passthrough),
        n_entries=len(entries),
        n_passthrough_collectives=n_pass,
        n_shape_exchanges=n_shapes,
    )


def _device_of(states: Sequence[Mapping[str, Any]]) -> Optional[torch.device]:
    for state in states:
        for value in state.values():
            if isinstance(value, torch.Tensor):
                return value.device
            if isinstance(value, tuple) and value:
                return value[0].device
    return None


def apply_sync_plan(
    plan: SyncPlan, states: Sequence[Mapping[str, Any]], weight: Optional[Any] = None
) -> List[State]:
    """Run one coalesced sync: per bucket, flatten every slot, ONE
    ``all_reduce``, slice back; MEAN slots divide by the world size. Then
    the passthrough leaves, one by one. Every rank must call it with states
    of the same structure."""
    _unported(weight=weight)
    outs: List[State] = [{} for _ in range(plan.n_entries)]
    for bucket in plan.buckets:
        flat = torch.cat([states[s.entry][s.name].reshape(-1) for s in bucket.slots])
        red = all_reduce(flat, bucket.op)
        offset = 0
        for s in bucket.slots:
            seg = red[offset : offset + s.size].reshape(s.shape)
            outs[s.entry][s.name] = seg / world_size() if s.mean else seg
            offset += s.size
    device = _device_of(states)
    for e, name, reduce in plan.passthrough:
        outs[e][name] = sync_leaf(reduce, states[e][name], device)
    return outs


def coalesced_sync_state(
    state: Mapping[str, Any],
    reductions: Mapping[str, Union[Reduce, Callable]],
    compression: Optional[Any] = None,
    weight: Optional[Any] = None,
    shardings: Optional[Any] = None,
) -> State:
    """Bucketed sync of one state: every key is in the reduction table or is
    the reserved ``_n`` counter (summed)."""
    plan = build_sync_plan([(reductions, state)], compression=compression, shardings=shardings)
    return apply_sync_plan(plan, [state], weight=weight)[0]


def _metric_entry(metric: Any, state: Mapping[str, Any]) -> Tuple[Mapping[str, Any], State]:
    """Every registered leaf of ``state`` plus the reserved ``_n`` counter."""
    sub: State = {name: state[name] for name in metric._reductions}
    sub[_N] = state[_N]
    return metric._reductions, sub


def plan_for_metrics(metrics: Sequence[Any], states: Sequence[Mapping[str, Any]]) -> SyncPlan:
    """The one bucket plan that :func:`coalesced_metric_sync` runs."""
    return build_sync_plan([_metric_entry(m, s) for m, s in zip(metrics, states)])


def _own_sync(metric: Any) -> bool:
    """True for a metric whose ``sync_states`` replaces the leaf-wise sync (Pearson's moments)."""
    from torchmetrics_tpu_torch.core.metric import Metric

    return isinstance(metric, Metric) and type(metric).sync_states is not Metric.sync_states


def coalesced_metric_sync(
    metrics: Sequence[Any],
    states: Sequence[Mapping[str, Any]],
    compression: Optional[Any] = None,
    weight: Optional[Any] = None,
) -> List[State]:
    """Sync several metrics' states with ONE cross-metric bucket plan.

    A metric that overrides ``sync_states`` (its leaves do not combine one by
    one) is synced by its own method after the plan, in the given order, so
    every rank issues the same collectives.
    """
    _unported(compression=compression)
    leaf_wise = [i for i, m in enumerate(metrics) if not _own_sync(m)]
    subs = [_metric_entry(metrics[i], states[i])[1] for i in leaf_wise]
    synced = apply_sync_plan(plan_for_metrics([metrics[i] for i in leaf_wise], [states[i] for i in leaf_wise]),
                             subs, weight=weight)
    out: List[State] = [None] * len(metrics)  # type: ignore[list-item]
    for i, st in zip(leaf_wise, synced):
        out[i] = st
    for i, m in enumerate(metrics):
        if out[i] is None:
            out[i] = m.sync_states(states[i], weight=weight)
    return out
