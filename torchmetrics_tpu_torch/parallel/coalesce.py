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

A plan may also compress its large float32 sum buckets (``bf16`` or
``int8``, :mod:`.compress`) and route sharded SUM leaves into buckets whose
sync is one ``reduce_scatter`` (each rank keeps its block). ``weight``, this
rank's 0/1 quarantine mask, takes a rank out of a sync. :class:`SyncPolicy`
and :class:`SyncStepper` defer the collective: each rank folds its batches
into its own running state and syncs every ``k`` steps or at compute.
:func:`coalesced_host_sync` is the host-gather form with an injectable
``allgather``. JAX's ``SyncAdvisor`` reads the telemetry registry, which is
not ported yet, so it is not here.

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
from torch import Tensor

from torchmetrics_tpu_torch.core.reductions import (
    Reduce,
    SketchReduce,
    all_gather_rows,
    all_reduce,
    canonical_reduce,
    reduce_scatter_rows,
    sync_leaf,
    world_size,
)
from torchmetrics_tpu_torch.parallel.compress import (
    CompressionConfig,
    CompressionSpec,
    compressed_psum,
    compressed_psum_scatter,
    compression_spec_for,
    host_dequantize_sum_int8,
    host_quantize_int8,
)

__all__ = [
    "Bucket",
    "CompressionConfig",
    "CompressionSpec",
    "SyncPlan",
    "SyncPolicy",
    "SyncStepper",
    "apply_sync_plan",
    "build_sync_plan",
    "bucket_scatter_size",
    "bucketed_collective_count",
    "cadence_stepper",
    "coalesced_host_sync",
    "coalesced_metric_sync",
    "coalesced_sync_state",
    "flush_sync",
    "per_leaf_collective_count",
    "plan_for_metric",
    "plan_for_metrics",
]

State = Dict[str, Any]

_N = "_n"

#: reductions that are one elementwise all-reduce and can share a bucket
_PSUM_FAMILY = (Reduce.SUM, Reduce.MEAN, Reduce.MAX, Reduce.MIN)
_OP_OF = {Reduce.SUM: "sum", Reduce.MEAN: "sum", Reduce.MAX: "max", Reduce.MIN: "min"}

#: the resilience slice (``resilience/divergence.py``, ``resilience/quarantine.py``) is not ported yet
_ITEM_9 = "is not ported yet: it needs the resilience slice (ROADMAP Queue 1 item 9)"


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
    #: the leaf dimension scattered over the ranks (a sharded SUM leaf); ``None`` for a replicated leaf
    shard_axis: Optional[int] = None


@dataclass(frozen=True)
class Bucket:
    """All same-``(dtype, op)`` psum-family leaves fused into one collective.

    ``compression`` is ``None`` for an exact bucket and a
    :class:`~torchmetrics_tpu_torch.parallel.compress.CompressionSpec` where
    the planner quantizes its payload; a ``sharded`` bucket's sync is one
    ``reduce_scatter`` and each rank keeps its block.
    """

    dtype: str
    op: str  # "sum" | "min" | "max"
    slots: Tuple[_Slot, ...]
    compression: Optional[CompressionSpec] = None
    sharded: bool = False

    @property
    def size(self) -> int:
        return sum(s.size for s in self.slots)

    @property
    def nbytes(self) -> int:
        return self.size * torch.empty((), dtype=getattr(torch, self.dtype)).element_size()

    @property
    def n_collectives(self) -> int:
        """Collectives the bucket issues: the int8 all-reduce is two (``all_to_all``, ``all_gather``); a
        sharded bucket is always one (its int8 form drops the ``all_gather``)."""
        if self.sharded:
            return 1
        return 1 if self.compression is None else self.compression.n_collectives


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
        gathers each of its elements. A weighted sync with MEAN leaves adds
        one ``all_reduce`` of the weights.
        """
        return sum(b.n_collectives for b in self.buckets) + self.n_passthrough_collectives

    def bucket_sizes(self) -> Dict[str, int]:
        """``{"dtype/op": element count}`` per bucket."""
        return {f"{b.dtype}/{b.op}": b.size for b in self.buckets}

    def bucket_bytes(self) -> Dict[str, int]:
        """``{"dtype/op": bytes}`` per bucket."""
        return {f"{b.dtype}/{b.op}": b.nbytes for b in self.buckets}


def bucket_scatter_size(bucket: Bucket, n_devices: int) -> int:
    """Elements a bucket moves: its size, or for a sharded bucket the size with each slot's shard dimension
    rounded up to a multiple of ``n_devices``."""
    if not bucket.sharded:
        return bucket.size
    n = max(int(n_devices), 1)
    total = 0
    for s in bucket.slots:
        dim = s.shape[s.shard_axis or 0]
        tail = s.size // max(dim, 1)
        total += (-(-dim // n) * n) * tail
    return total


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


def build_sync_plan(
    entries: Sequence[Tuple[Mapping[str, Any], Mapping[str, Any]]],
    compression: Optional[CompressionConfig] = None,
    shardings: Optional[Sequence[Optional[Mapping[str, Any]]]] = None,
) -> SyncPlan:
    """Plan one coalesced sync over ``entries`` = [(reduction table, state), ...].

    Several entries (one per compute-group leader) share buckets. Buckets
    sort by ``(dtype, op, sharded)``; slots follow entry and table order.
    ``compression`` quantizes the float32 sum buckets at or above its byte
    floor whose declared bound fits its budget; ``shardings`` (one ``None``
    or ``{leaf: ShardSpec}`` per entry) routes sharded SUM leaves into
    buckets of their own. Without either the plan is the exact planner's.
    """
    groups: Dict[Tuple[str, str, bool], List[_Slot]] = {}
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
                groups.setdefault((dtype_name(value.dtype), reduce.bucket_op, False), []).append(slot)
                continue
            gathered = not isinstance(reduce, Reduce) or reduce not in _PSUM_FAMILY
            int_mean = reduce == Reduce.MEAN and not value.dtype.is_floating_point
            if gathered or int_mean:
                passthrough.append((e, name, reduce))
                n_pass += 1
                n_shapes += 1 if gathered else 0
                continue
            spec = None
            if reduce == Reduce.SUM and shardings is not None and shardings[e]:
                spec = shardings[e].get(name)
            slot = _Slot(entry=e, name=name, shape=tuple(value.shape), size=value.numel(),
                         mean=reduce == Reduce.MEAN, shard_axis=None if spec is None else int(spec.axis))
            groups.setdefault((dtype_name(value.dtype), _OP_OF[reduce], spec is not None), []).append(slot)
    buckets = []
    for (dt, op, sharded), slots in sorted(groups.items()):
        bucket = Bucket(dtype=dt, op=op, slots=tuple(slots), sharded=sharded)
        spec = compression_spec_for(dt, op, bucket.nbytes, compression)
        buckets.append(Bucket(dtype=dt, op=op, slots=bucket.slots, compression=spec, sharded=sharded))
    return SyncPlan(
        buckets=tuple(buckets),
        passthrough=tuple(passthrough),
        n_entries=len(entries),
        n_passthrough_collectives=n_pass,
        n_shape_exchanges=n_shapes,
    )


def _apply_sharded_bucket(bucket: Bucket, states: Sequence[Mapping[str, Any]], w: Optional[Tensor],
                          outs: List[State]) -> None:
    """One sharded SUM bucket as ONE ``reduce_scatter``: each slot's shard axis to the front, zero-padded to a
    multiple of the world size ``n`` and viewed as ``(n, k)`` (row ``i`` is the block rank ``i`` keeps); the
    slots side by side; this rank's row of the sum sliced back into each slot's block."""
    n = world_size()
    mats, layout = [], []
    for s in bucket.slots:
        ax = s.shard_axis or 0
        x = torch.movedim(states[s.entry][s.name], ax, 0)
        d = x.shape[0]
        if n > 1 and d == 1:
            raise ValueError(
                f"sharded leaf {s.name!r} has a shard dimension of 1: its block on {n} ranks could not be told "
                "from the leaf itself; shard a longer axis or keep the leaf replicated"
            )
        pad = (-d) % n
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        mat = x.reshape(n, -1)
        mats.append(mat)
        layout.append((s, tuple(x.shape[1:]), d + pad, mat.shape[1]))
    mat = mats[0] if len(mats) == 1 else torch.cat(mats, dim=1)
    if w is not None:
        mat = mat * w.to(mat.dtype)
    if bucket.compression is not None:
        red = compressed_psum_scatter(mat, bucket.compression)
    else:
        red = reduce_scatter_rows(mat)
    offset = 0
    for s, tail, padded_dim, cols in layout:
        seg = red[offset : offset + cols].reshape((padded_dim // n, *tail))
        outs[s.entry][s.name] = torch.movedim(seg, 0, s.shard_axis or 0)
        offset += cols


def _mask_identity(dtype: torch.dtype, op: str) -> Tensor:
    """What a quarantined rank contributes to a min or max bucket: +inf / iinfo.max for min, -inf / iinfo.min
    for max."""
    if dtype.is_floating_point:
        return torch.tensor(float("inf") if op == "min" else -float("inf"), dtype=dtype)
    info = torch.iinfo(dtype)
    return torch.tensor(info.max if op == "min" else info.min, dtype=dtype)


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
    """Run one coalesced sync: per bucket, flatten every slot, ONE collective (two for an int8 all-reduce),
    slice back; MEAN slots divide by the world size. Then the passthrough leaves, one by one. Every rank must
    call it with states of the same structure.

    ``weight`` (``None``, or this rank's 0/1 scalar) is the quarantine mask:
    a sum bucket contributes ``flat * w``, a min or max bucket its identity
    where ``w == 0``, and MEAN slots divide by the sum of the ranks' weights
    (clamped to 1), the mean over the ranks that take part. Passthrough leaves
    gather raw per-rank payloads and cannot be masked: a weighted plan with
    any raises ``ValueError``.
    """
    if weight is not None and plan.passthrough:
        names = sorted({name for _, name, _ in plan.passthrough})
        raise ValueError(
            f"masked (quarantined) sync cannot exclude a replica from passthrough "
            f"leaves {names}: cat/custom/structural-sketch leaves gather raw "
            "per-replica payloads rather than reducing them. Quarantine supports "
            "psum-family state only."
        )
    outs: List[State] = [{} for _ in range(plan.n_entries)]
    device = _device_of(states)
    w = None if weight is None else torch.as_tensor(weight, device=device).reshape(())
    quorum: Optional[Tensor] = None
    for bucket in plan.buckets:
        if bucket.sharded:
            _apply_sharded_bucket(bucket, states, w, outs)
            continue
        parts = [states[s.entry][s.name].reshape(-1) for s in bucket.slots]
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        if w is not None:
            if bucket.op == "sum":
                flat = flat * w.to(flat.dtype)
            else:
                flat = torch.where(w > 0, flat, _mask_identity(flat.dtype, bucket.op).to(flat.device))
        if bucket.compression is not None:
            red = compressed_psum(flat, bucket.compression)
        else:
            red = all_reduce(flat, bucket.op)
        offset = 0
        for s in bucket.slots:
            seg = red[offset : offset + s.size].reshape(s.shape)
            if s.mean:
                if w is None:
                    seg = seg / world_size()
                else:
                    if quorum is None:
                        quorum = all_reduce(w.to(torch.float32), "sum")
                    seg = seg / torch.clamp(quorum.to(seg.dtype), min=1)
            outs[s.entry][s.name] = seg
            offset += s.size
    for e, name, reduce in plan.passthrough:
        outs[e][name] = sync_leaf(reduce, states[e][name], device)
    return outs


def coalesced_sync_state(
    state: Mapping[str, Any],
    reductions: Mapping[str, Union[Reduce, Callable]],
    compression: Optional[CompressionConfig] = None,
    weight: Optional[Any] = None,
    shardings: Optional[Mapping[str, Any]] = None,
) -> State:
    """Bucketed sync of one state: every key is in the reduction table or is the reserved ``_n`` counter
    (summed). ``shardings`` (``{leaf: ShardSpec}``) sends sharded SUM leaves through the reduce-scatter: each
    rank gets its block back."""
    plan = build_sync_plan([(reductions, state)], compression=compression,
                           shardings=None if not shardings else [shardings])
    return apply_sync_plan(plan, [state], weight=weight)[0]


def _metric_entry(metric: Any, state: Mapping[str, Any]) -> Tuple[Mapping[str, Any], State]:
    """Every registered leaf of ``state`` plus the reserved ``_n`` counter."""
    sub: State = {name: state[name] for name in metric._reductions}
    sub[_N] = state[_N]
    return metric._reductions, sub


def _metric_shardings(metric: Any) -> Optional[Mapping[str, Any]]:
    """The metric's ``{leaf: ShardSpec}``, or ``None`` when nothing is sharded."""
    return getattr(metric, "_state_shardings", None) or None


def _own_sync(metric: Any) -> bool:
    """True for a metric whose ``sync_states`` replaces the leaf-wise sync (Pearson's moments)."""
    from torchmetrics_tpu_torch.core.metric import Metric

    return isinstance(metric, Metric) and type(metric).sync_states is not Metric.sync_states


def plan_for_metric(metric: Any, state: Optional[Mapping[str, Any]] = None,
                    compression: Optional[CompressionConfig] = None) -> SyncPlan:
    """The plan one ``sync_states`` call on ``metric`` runs (``state`` defaults to the live state)."""
    if state is None:
        state = metric._state
    return build_sync_plan([_metric_entry(metric, state)], compression=compression,
                           shardings=[_metric_shardings(metric)])


def plan_for_metrics(metrics: Sequence[Any], states: Sequence[Mapping[str, Any]],
                     compression: Optional[CompressionConfig] = None) -> SyncPlan:
    """The one bucket plan that :func:`coalesced_metric_sync` runs over the metrics whose ``sync_states`` is
    the leaf-wise one (JAX returns the plan with their indices; this returns the plan)."""
    standard = [i for i, m in enumerate(metrics) if not _own_sync(m)]
    shardings = [_metric_shardings(metrics[i]) for i in standard]
    return build_sync_plan([_metric_entry(metrics[i], states[i]) for i in standard], compression=compression,
                           shardings=shardings if any(shardings) else None)


def coalesced_metric_sync(
    metrics: Sequence[Any],
    states: Sequence[Mapping[str, Any]],
    compression: Optional[CompressionConfig] = None,
    weight: Optional[Any] = None,
) -> List[State]:
    """Sync several metrics' states with ONE cross-metric bucket plan.

    A metric that overrides ``sync_states`` (its leaves do not combine one by
    one) is synced by its own method after the plan, in the given order, so
    every rank issues the same collectives. It is called without the
    compression, so its sync stays exact, as in JAX; a weight is passed on
    (Pearson's ``sync_states`` takes none and raises ``TypeError``, as
    JAX's does).
    """
    standard = [i for i, m in enumerate(metrics) if not _own_sync(m)]
    plan = plan_for_metrics(metrics, states, compression=compression)
    synced = apply_sync_plan(plan, [_metric_entry(metrics[i], states[i])[1] for i in standard], weight=weight)
    out: List[Optional[State]] = [None] * len(metrics)
    for i, st in zip(standard, synced):
        out[i] = st
    for i, m in enumerate(metrics):
        if out[i] is None:
            out[i] = m.sync_states(states[i]) if weight is None else m.sync_states(states[i], weight=weight)
    return out  # type: ignore[return-value]


# ---------------------------------------------------------------- accounting
def bucketed_collective_count(reductions: Mapping[str, Any], state: Mapping[str, Any],
                              compression: Optional[CompressionConfig] = None,
                              shardings: Optional[Mapping[str, Any]] = None) -> int:
    """Collectives one coalesced sync of ``state`` launches (JAX's count model)."""
    return build_sync_plan([(reductions, state)], compression=compression,
                           shardings=None if not shardings else [shardings]).n_collectives


def per_leaf_collective_count(reductions: Mapping[str, Any], state: Mapping[str, Any]) -> int:
    """Collectives a per-leaf sync loop would launch (a list state one per item, as in JAX)."""
    n = 0
    for name, value in state.items():
        _reduce_for(name, reductions)  # validate, same contract
        n += len(value) if isinstance(value, tuple) else 1
    return n


# ----------------------------------------------------------- the host gather
def _rank_order_sum(gathered: Tensor) -> Tensor:
    """The sum over the leading axis, rows added in order from zero (XLA's order of a small reduce)."""
    acc = torch.zeros_like(gathered[0])
    for row in gathered:
        acc = acc + row
    return acc


def _default_allgather(x: Tensor) -> Tensor:
    return all_gather_rows(x)


def coalesced_host_sync(
    state: Mapping[str, Any],
    reductions: Mapping[str, Union[Reduce, Callable]],
    *,
    n_processes: Optional[int] = None,
    allgather: Optional[Callable[[Any], Any]] = None,
    compression: Optional[CompressionConfig] = None,
    owner: Optional[Any] = None,
) -> State:
    """Cross-process sync with one gather per bucket, each process's copy reduced on arrival.

    JAX's stage 2 of the two-stage reduce: a state already reduced within a
    host crosses once per process. ``compression`` shrinks each process's
    payload: bf16 gathers half-width values; int8 packs them once (one
    quantization stage) and the arrived copies are dequantized and summed in
    process order, one ``int8_dequant_sum`` launch on a CUDA tensor.
    Passthrough leaves sync one by one (:func:`sync_leaf`).

    ``n_processes`` defaults to the world size and ``allgather`` (a tensor ->
    ``(n_processes, *shape)``) to one ``all_gather`` over the default group;
    both are injectable. With one process the state comes back untouched.
    ``owner`` is accepted; JAX records its passthrough gather in the telemetry
    registry while that is enabled (off by default), and the port has no
    registry yet, so it records nothing.
    """
    plan = build_sync_plan([(reductions, state)], compression=compression)  # validates leaf names
    n_proc = world_size() if n_processes is None else int(n_processes)
    if n_proc == 1:
        return dict(state)
    allgather = allgather or _default_allgather
    out: State = {}
    for bucket in plan.buckets:
        parts = [torch.as_tensor(state[s.name]).reshape(-1) for s in bucket.slots]
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        spec = bucket.compression
        if spec is not None and spec.mode == "bf16":
            gathered = torch.as_tensor(allgather(flat.to(torch.bfloat16)), device=flat.device)
            red = _rank_order_sum(gathered.to(flat.dtype))
        elif spec is not None and spec.mode == "int8":
            gathered = torch.as_tensor(allgather(host_quantize_int8(flat, spec.chunk)), device=flat.device)
            red = host_dequantize_sum_int8(gathered, bucket.size, spec.chunk)
        else:
            gathered = torch.as_tensor(allgather(flat), device=flat.device)
            if bucket.op == "sum":
                red = _rank_order_sum(gathered)
            else:
                red = gathered.amax(0) if bucket.op == "max" else gathered.amin(0)
        offset = 0
        for s in bucket.slots:
            seg = red[offset : offset + s.size].reshape(s.shape)
            # a tensor divisor: on CUDA a Python number would be a reciprocal multiply, the host path divides
            out[s.name] = seg / torch.tensor(float(n_proc), dtype=seg.dtype, device=seg.device) if s.mean else seg
            offset += s.size
    device = _device_of([state])
    for _, name, reduce in plan.passthrough:
        out[name] = sync_leaf(reduce, state[name], device)
    return out


# ------------------------------------------------------------------- cadence
@dataclass(frozen=True)
class SyncPolicy:
    """When the cross-rank collective runs.

    ``SyncPolicy()`` / ``SyncPolicy(every_n_steps=1)`` syncs every step.
    ``every_n_steps=k`` accumulates locally for ``k`` steps and syncs on every
    ``k``-th; ``at_compute=True`` defers the only collective to ``compute``.
    Sound because every reduction of a table is associative; deferral changes
    the order of float sums, so it is bit-exact for integer-valued sums (the
    classification counts) and may differ in the last bits for float means.

    ``compression`` (``"bf16"`` or ``"int8"``) quantizes the large float32
    sum buckets; ``error_budget`` caps the declared bound a compressed bucket
    may have. ``"none"``, the default, keeps every sync exact.
    """

    every_n_steps: Optional[int] = None
    at_compute: bool = False
    compression: str = "none"
    error_budget: Optional[float] = None

    def __post_init__(self) -> None:
        CompressionConfig.from_mode(self.compression, self.error_budget)  # raises ValueError on misuse
        if self.at_compute:
            if self.every_n_steps is not None:
                raise ValueError("SyncPolicy: pass either every_n_steps=k or at_compute=True, not both")
        else:
            k = 1 if self.every_n_steps is None else self.every_n_steps
            if not (isinstance(k, int) and not isinstance(k, bool) and k >= 1):
                raise ValueError(f"SyncPolicy.every_n_steps must be an int >= 1, got {self.every_n_steps!r}")
            object.__setattr__(self, "every_n_steps", k)

    @property
    def defers(self) -> bool:
        """True when some steps run without a collective."""
        return self.at_compute or self.every_n_steps > 1

    @property
    def compression_config(self) -> Optional[CompressionConfig]:
        """``None`` for exact syncs, else the planner's config."""
        return CompressionConfig.from_mode(self.compression, self.error_budget)

    def should_sync(self, pending: int) -> bool:
        return (not self.at_compute) and pending >= self.every_n_steps

    @classmethod
    def every_n(cls, k: int) -> "SyncPolicy":
        """``SyncPolicy(every_n_steps=k)``."""
        return cls(every_n_steps=k)


def _check_divergence_options(verify_consistency: bool, on_divergence: str) -> None:
    if on_divergence not in ("raise", "quarantine"):
        raise ValueError(f'on_divergence must be "raise" or "quarantine", got {on_divergence!r}')
    if verify_consistency:
        raise NotImplementedError(f"verify_consistency=True {_ITEM_9}")
    if on_divergence == "quarantine":
        raise NotImplementedError(f'on_divergence="quarantine" {_ITEM_9}')


class SyncStepper:
    """Cadence-controlled accumulation for a metric or a collection.

    Each rank keeps its own running state (its carry), folds every step's
    batch in with ``update_state`` and no collective, and syncs the window
    through :func:`coalesced_metric_sync` only when the :class:`SyncPolicy`
    says so, or at :meth:`compute`. The synced windows merge into the
    cumulative state by the metrics' ``merge_states``. Every rank must drive
    its stepper through the same steps: the syncs are collectives.

    :meth:`snapshot` / :meth:`restore` capture the cumulative state and the
    open window's carry; a snapshot records the world size, and a restore
    into another world size raises ``StateRestoreError(reason="mesh-shape")``.
    ``verify_consistency=True`` and ``on_divergence="quarantine"`` need the
    resilience slice, not ported yet: they raise ``NotImplementedError``.

    Example::

        stepper = SyncStepper(collection, policy=SyncPolicy(every_n_steps=4))
        for batch in loader:            # this rank's batches
            stepper.update(*batch)      # a collective on every 4th step only
        results = stepper.compute()     # syncs the open window
    """

    _SNAP_VERSION = 1

    def __init__(self, target: Any, policy: Optional[SyncPolicy] = None, verify_consistency: bool = False,
                 on_divergence: str = "raise") -> None:
        _check_divergence_options(verify_consistency, on_divergence)
        self.target = target
        self.policy = policy if policy is not None else SyncPolicy()
        self.verify_consistency = verify_consistency
        self.on_divergence = on_divergence
        self._is_collection = hasattr(target, "_functional_groups")
        if self._is_collection:
            names = tuple(members[0] for members in target._functional_groups().values())
            self._members: Tuple[Tuple[str, Any], ...] = tuple((n, target[n]) for n in names)
        else:
            self._members = (("", target),)
        listy = [n or type(m).__name__ for n, m in self._members
                 if any(isinstance(v, tuple) for v in m._defaults.values())]
        if listy:
            raise ValueError(
                f"SyncStepper accumulates fixed-size (psum-family) states; "
                f"{listy} hold list (cat) states. Use DeferredRaggedSync for those — "
                "it already defers the gather to compute."
            )
        self._local: Optional[Dict[str, State]] = None  # {name: this rank's open window}
        self._synced: Optional[Dict[str, State]] = None  # {name: cumulative synced state}
        self._steps = 0
        self._pending = 0

    @property
    def steps(self) -> int:
        """Update steps folded in so far."""
        return self._steps

    @property
    def pending(self) -> int:
        """Steps accumulated since the last collective."""
        return self._pending

    def _unwrap(self, per_name: Dict[str, Any]) -> Any:
        return per_name if self._is_collection else per_name[""]

    def update(self, *inputs: Any) -> Optional[Any]:
        """Fold this rank's batch in. Returns the cumulative synced state(s) on sync steps, ``None`` on
        deferred ones."""
        if self._local is None:
            self._local = {name: m.init_state() for name, m in self._members}
        for name, m in self._members:
            self._local[name] = m.update_state(self._local[name], *inputs)
        self._steps += 1
        self._pending += 1
        if self.policy.should_sync(self._pending):
            return self.sync()
        return None

    def sync(self) -> Any:
        """Sync the open window (if any) with one coalesced plan and return the cumulative state(s)."""
        if self._local is not None:
            names = [name for name, _ in self._members]
            window = dict(zip(names, coalesced_metric_sync(
                [m for _, m in self._members], [self._local[n] for n in names],
                compression=self.policy.compression_config)))
            if self._synced is None:
                self._synced = window
            else:
                self._synced = {name: m.merge_states(self._synced[name], window[name]) for name, m in self._members}
            self._local = None
            self._pending = 0
        if self._synced is None:
            raise RuntimeError("SyncStepper.sync called before any update")
        return self._unwrap(self._synced)

    def compute(self) -> Any:
        """Sync the pending steps, then compute from the cumulative state(s)."""
        synced = self.sync()
        if not self._is_collection:
            return self.target.compute_state(synced)
        return self.target.compute_states(synced)

    def reset(self) -> None:
        self._local = None
        self._synced = None
        self._steps = 0
        self._pending = 0

    # ------------------------------------------------------------- resilience
    def snapshot(self) -> Dict[str, Any]:
        """CPU copies of the cumulative state and of this rank's open window (taken mid-window, it keeps the
        steps not synced yet), with the world size as ``n_devices``."""
        def cpu(tree):
            return None if tree is None else {n: {k: v.detach().cpu().clone() for k, v in st.items()}
                                              for n, st in tree.items()}

        return {"version": self._SNAP_VERSION, "steps": self._steps, "pending": self._pending,
                "n_devices": world_size(), "synced": cpu(self._synced), "local": cpu(self._local)}

    def _expected_shape(self, m: Any, leaf: str, default: Tensor, synced: bool, n: int) -> Tuple[int, ...]:
        shape = list(default.shape)
        spec = (getattr(m, "_state_shardings", None) or {}).get(leaf)
        if synced and spec is not None:  # a synced sharded leaf holds this rank's block
            shape[spec.axis] = -(-shape[spec.axis] // n)
        return tuple(shape)

    def restore(self, snap: Mapping[str, Any]) -> None:
        """Check, then install, a :meth:`snapshot`."""
        from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError

        if not isinstance(snap, Mapping) or snap.get("version") != self._SNAP_VERSION:
            raise StateRestoreError(
                f"not a SyncStepper snapshot (version {self._SNAP_VERSION}): "
                f"got {type(snap).__name__} with version {getattr(snap, 'get', lambda *_: None)('version')}"
            )
        n = world_size()
        snap_n = snap.get("n_devices")
        if snap_n is not None and int(snap_n) != n:
            raise StateRestoreError(
                f"the snapshot carries per-rank state of a {int(snap_n)}-rank world, but this stepper runs "
                f"in a world of {n}: its open windows and sharded blocks do not map onto these ranks.",
                reason="mesh-shape",
                mesh_shape=(int(snap_n),),
            )
        names = [name for name, _ in self._members]

        def check_tree(kind: str, tree: Any) -> None:
            if tree is None:
                return
            if sorted(tree) != sorted(names):
                raise StateRestoreError(f"snapshot {kind} states name {sorted(tree)}, stepper expects {sorted(names)}")
            for name, m in self._members:
                for leaf, default in m.init_state().items():
                    if leaf not in tree[name]:
                        raise StateRestoreError(f"snapshot {kind}[{name!r}] is missing leaf {leaf!r}", leaf=leaf,
                                                reason="missing-leaf")
                    arr = torch.as_tensor(tree[name][leaf])
                    want = self._expected_shape(m, leaf, default, kind == "synced", n)
                    if tuple(arr.shape) != want or arr.dtype != default.dtype:
                        raise StateRestoreError(
                            f"snapshot {kind}[{name!r}][{leaf!r}] has shape {tuple(arr.shape)}/{arr.dtype}, "
                            f"expected {want}/{default.dtype}", leaf=leaf, reason="shape")

        check_tree("synced", snap.get("synced"))
        check_tree("local", snap.get("local"))
        members = dict(self._members)

        def install(tree: Optional[Mapping[str, Any]]) -> Optional[Dict[str, State]]:
            return None if tree is None else {name: {leaf: torch.as_tensor(v).to(members[name].device)
                                                     for leaf, v in st.items()} for name, st in tree.items()}

        self._synced = install(snap.get("synced"))
        self._local = install(snap.get("local"))
        self._steps = int(snap["steps"])
        self._pending = int(snap["pending"])


def cadence_stepper(target: Any, policy: SyncPolicy, verify_consistency: bool = False,
                    on_divergence: str = "raise") -> SyncStepper:
    """The :class:`SyncStepper` behind ``sharded_update(..., sync_policy=...)``, kept on the target (dropped
    when it is pickled or copied). The policy must stay the same across steps: state accumulated under one
    cadence cannot be read under another."""
    stepper: Optional[SyncStepper] = target.__dict__.get("_cadence_stepper")
    if stepper is not None:
        if (stepper.policy != policy or stepper.verify_consistency != verify_consistency
                or stepper.on_divergence != on_divergence):
            raise ValueError(
                "sync_policy cadence arguments changed mid-accumulation "
                f"(policy {stepper.policy} -> {policy}); call flush_sync(...) and reset, "
                "or drive a SyncStepper explicitly for dynamic cadences"
            )
        return stepper
    stepper = SyncStepper(target, policy=policy, verify_consistency=verify_consistency, on_divergence=on_divergence)
    target.__dict__["_cadence_stepper"] = stepper
    return stepper


def flush_sync(target: Any) -> Any:
    """Sync the pending steps of ``sharded_update(..., sync_policy=...)`` / ``sharded_collection_update`` and
    return the cumulative state(s)."""
    stepper: Optional[SyncStepper] = target.__dict__.get("_cadence_stepper")
    if stepper is None:
        raise RuntimeError(
            f"{type(target).__name__} has no pending cadence state — pass sync_policy= to "
            "sharded_update/sharded_collection_update first (or drive a SyncStepper directly)"
        )
    return stepper.sync()
