"""Per-state reduction specs (counterpart of ``torchmetrics_tpu/core/reductions.py``).

The ``dist_reduce_fx`` given to ``Metric.add_state`` says how two copies of a
state leaf combine, in two lowerings of one semantic operation:

* ``merge_leaf(a, b)``: the local pairwise combine that ``forward``
  accumulation and checkpoint joining use;
* ``sync_leaf(value)``: the cross-process combine, an eager collective on
  ``torch.distributed``'s default process group (NCCL on the GPU, gloo on
  the CPU). SUM, MAX and MIN are one ``all_reduce``; MEAN is a sum divided by
  the world size (an integer leaf comes back as float32, as JAX's ``pmean``
  true-divides it); CAT, NONE and callables gather. A
  :class:`SketchReduce` leaf (``torchmetrics_tpu_torch.sketches``) with a
  ``bucket_op`` is one ``all_reduce`` of that op; a structural one (a
  reservoir) is one fixed-shape ``all_gather`` and its ``combine_stacked``.

JAX's in-graph ``sync_leaf`` and its cross-process ``host_sync_leaf`` are one
function here: ``torch.distributed`` is already cross-process.

List ("cat") states are tuples of tensors. A synced CAT list state is a
tuple of ONE tensor: each rank concatenates its items and the rows are
gathered once, rank after rank, as the reference TorchMetrics orders them.
JAX gathers each tuple element over the mesh instead, which interleaves the
devices element by element; the rows are the same multiset.

Every collective the port issues is counted in :data:`COLLECTIVES` by kind:
``all_reduce``, ``all_gather`` (data), ``shape_gather`` (the small exchange
of shapes that an uneven gather needs first), and the compressed and
sharded syncs' ``all_to_all`` and ``reduce_scatter``. NCCL and gloo run
each of them on CUDA tensors (gloo's ``reduce_scatter_tensor`` takes its
input as one flat tensor): the port copies nothing to the host for them.

A SUM tensor leaf may be sharded over the ranks (:class:`ShardSpec`): its
sync is one ``reduce_scatter`` and each rank keeps only its block.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import Tensor


class Reduce(str, Enum):
    SUM = "sum"
    MEAN = "mean"
    MAX = "max"
    MIN = "min"
    CAT = "cat"
    NONE = "none"
    #: marker value only: a sketch leaf registers a concrete :class:`SketchReduce`, never the bare string
    SKETCH = "sketch"


@dataclass(frozen=True)
class SketchReduce:
    """Reduction spec of a fixed-shape mergeable sketch leaf.

    ``bucket_op`` in ``"sum" | "max" | "min"`` declares the merge as that
    elementwise op: such a leaf rides the coalescing planner's fused dtype
    bucket of the op, as SUM/MAX/MIN leaves do. ``bucket_op=None`` declares a
    structural merge (a reservoir's sort-and-keep-k): ``combine_stacked``
    folds a stacked ``(m, *leaf_shape)`` tensor of sketches into one, and the
    sync is one fixed-shape gather and the combine.
    """

    kind: str
    bucket_op: Optional[str] = None
    combine_stacked: Optional[Callable] = None

    def __post_init__(self) -> None:
        if self.bucket_op not in (None, "sum", "max", "min"):
            raise ValueError(
                f"SketchReduce.bucket_op must be one of 'sum'/'max'/'min'/None, got {self.bucket_op!r}"
            )
        if self.bucket_op is None and self.combine_stacked is None:
            raise ValueError(
                "SketchReduce with bucket_op=None needs a `combine_stacked` callable "
                "(stacked (m, ...) sketches -> one merged sketch)"
            )

    @property
    def n_sync_gathers(self) -> int:
        """Fixed-shape gathers one sync of this leaf launches (0 when the merge rides an all-reduce bucket)."""
        return 0 if self.bucket_op is not None else 1


@dataclass(frozen=True)
class ShardSpec:
    """Sharding spec of one SUM-reduced tensor state leaf across the ranks.

    A sharded leaf's sync is one ``reduce_scatter`` (wire bytes ``(n-1)/n B``
    a rank instead of the all-reduce's ``2(n-1)/n B``) and each rank keeps
    only its ``B/n`` block until ``compute_state`` gathers. ``axis`` is the
    leaf dimension to scatter along; a dimension the world size does not
    divide is zero-padded (the SUM identity) to the next multiple, and
    ``compute_state`` slices the padding back off.
    """

    axis: int = 0

    def __post_init__(self) -> None:
        if not isinstance(self.axis, int) or self.axis < 0:
            raise ValueError(f"ShardSpec.axis must be a non-negative int, got {self.axis!r}")


def canonical_sharding(spec: Union[str, ShardSpec, None]) -> Optional[ShardSpec]:
    """``None``/``"replicated"`` -> ``None``; ``"sharded"`` -> ``ShardSpec(axis=0)``; a :class:`ShardSpec` as is."""
    if spec is None or spec == "replicated":
        return None
    if spec == "sharded":
        return ShardSpec(axis=0)
    if isinstance(spec, ShardSpec):
        return spec
    raise ValueError(f"state_sharding must be 'replicated', 'sharded', a ShardSpec, or None; got {spec!r}")


def is_sketch_reduce(fx: Any) -> bool:
    return isinstance(fx, SketchReduce)


ReduceFx = Union[Reduce, str, Callable, SketchReduce, None]
ListState = Tuple[Tensor, ...]


def canonical_reduce(fx: ReduceFx) -> Union[Reduce, Callable, SketchReduce]:
    """Normalize a user-provided ``dist_reduce_fx`` into a :class:`Reduce`, :class:`SketchReduce` or callable."""
    if fx is None:
        return Reduce.NONE
    if isinstance(fx, SketchReduce):
        return fx
    if isinstance(fx, Reduce) and fx is not Reduce.SKETCH:
        return fx
    if callable(fx):
        return fx
    try:
        canon = Reduce(str(fx.value if isinstance(fx, Reduce) else fx))
    except ValueError:
        raise ValueError(
            f"`dist_reduce_fx` must be one of {[r.value for r in Reduce]}, a callable, a SketchReduce spec, "
            f"or None; got {fx!r}"
        ) from None
    if canon is Reduce.SKETCH:
        raise ValueError(
            "dist_reduce_fx='sketch' is a marker, not a spec: pass a concrete SketchReduce instance "
            "(e.g. torchmetrics_tpu_torch.sketches.QuantileSketch(...).reduce_spec)"
        )
    return canon


def reduce_identity(reduce: Any, dtype: torch.dtype) -> Optional[Tensor]:
    """The absorbing identity of a canonical reduce, as a ``dtype`` scalar.

    ``merge(x, identity) == x`` for the elementwise families: 0 for SUM and
    MEAN, -inf/+inf for MAX/MIN (``iinfo.min``/``iinfo.max`` on integer
    leaves, False/True on bool leaves); a sketch with a ``bucket_op`` that of
    its op. CAT, NONE, structural sketches and callables have no elementwise
    identity: ``None``.
    """
    if isinstance(reduce, SketchReduce):
        if reduce.bucket_op is None:
            return None
        reduce = {"sum": Reduce.SUM, "max": Reduce.MAX, "min": Reduce.MIN}[reduce.bucket_op]
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
    if isinstance(reduce, SketchReduce):
        if reduce.bucket_op == "sum":
            return a + b
        if reduce.bucket_op == "max":
            return torch.maximum(a, b)
        if reduce.bucket_op == "min":
            return torch.minimum(a, b)
        return reduce.combine_stacked(torch.stack([a, b]))
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


# ------------------------------------------------------------- collectives
#: collectives issued by the port's sync layer, by kind (never reset here)
COLLECTIVES: Counter = Counter()

_MAX_NDIM = 8
# dtypes a gathered leaf may have, by code in the shape exchange
_DTYPES = (
    torch.float32, torch.int32, torch.bool, torch.uint8, torch.int8, torch.int16,
    torch.int64, torch.float64, torch.float16, torch.bfloat16,
)


def in_group() -> bool:
    """True when a default process group is up: collectives are issued then,
    with one rank too; without one, a sync is local."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks of the default process group; 1 when none is initialized."""
    return dist.get_world_size() if in_group() else 1


def default_device() -> torch.device:
    """Where a collective with no tensor of its own runs: the current CUDA
    device under NCCL, else the CPU."""
    if in_group() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(x: Tensor, op: str) -> Tensor:
    """``op`` ("sum", "max" or "min") of ``x`` over every rank, as a new tensor."""
    out = x.clone()
    if in_group():
        dist.all_reduce(out, op=getattr(dist.ReduceOp, _OPS[op]))
        COLLECTIVES["all_reduce"] += 1
    return out


def all_to_all_rows(x: Tensor) -> Tensor:
    """``x`` of ``(world, P)``: row ``j`` goes to rank ``j``; returns ``(world, P)`` with row ``j`` from rank ``j``."""
    if not in_group():
        return x.clone()
    src = x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src)
    COLLECTIVES["all_to_all"] += 1
    return out


def reduce_scatter_rows(x: Tensor) -> Tensor:
    """``x`` of ``(world, K)``: the sum over the ranks of row ``rank``, ``(K,)``."""
    if not in_group():
        return x[0].clone()
    out = torch.empty(x.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.reshape(-1), op=dist.ReduceOp.SUM)  # gloo wants the rows end to end
    COLLECTIVES["reduce_scatter"] += 1
    return out


def all_gather_rows(x: Tensor) -> Tensor:
    """Every rank's ``x``, stacked in rank order: ``(world, *x.shape)``; one list ``all_gather``."""
    if not in_group():
        return x[None].clone()
    return torch.stack(_all_gather_list(x, "all_gather"))


def _all_gather_list(x: Tensor, kind: str) -> List[Tensor]:
    """The list form of ``all_gather``, which gloo implements for CUDA tensors too."""
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    out = [torch.empty_like(wire) for _ in range(world_size())]
    dist.all_gather(out, wire)
    COLLECTIVES[kind] += 1
    return [o.to(torch.bool) for o in out] if x.dtype == torch.bool else out


def _exchange_shapes(
    x: Optional[Tensor], device: torch.device
) -> Tuple[List[Optional[Tuple[int, ...]]], Optional[torch.dtype]]:
    """Every rank's shape of ``x`` (``None`` where a rank has no tensor) and
    the common dtype, by one small gather. Ranks that disagree on rank or
    dtype all raise the same ``ValueError``."""
    header = torch.zeros((3 + _MAX_NDIM,), dtype=torch.int64)
    if x is not None:
        if x.ndim > _MAX_NDIM or x.dtype not in _DTYPES:
            raise ValueError(f"cannot gather a {x.ndim}-d {x.dtype} tensor")
        header[0], header[1], header[2] = 1, x.ndim, _DTYPES.index(x.dtype)
        header[3 : 3 + x.ndim] = torch.tensor(x.shape, dtype=torch.int64)
    rows = [h.cpu() for h in _all_gather_list(header.to(device), "shape_gather")]
    shapes: List[Optional[Tuple[int, ...]]] = []
    kinds = set()
    for h in rows:
        if int(h[0]) == 0:
            shapes.append(None)
            continue
        ndim = int(h[1])
        shapes.append(tuple(int(d) for d in h[3 : 3 + ndim]))
        kinds.add((ndim, int(h[2])))
    if len(kinds) > 1:
        raise ValueError(f"ranks hold tensors of different rank or dtype: {sorted(kinds)}")
    dtype = _DTYPES[kinds.pop()[1]] if kinds else None
    return shapes, dtype


def gather_all_tensors(x: Optional[Tensor], device: Optional[torch.device] = None) -> List[Optional[Tensor]]:
    """Every rank's ``x``, in rank order (``None`` for a rank that gave none).

    Shapes may differ in every dimension: each rank's tensor is padded with
    zeros to the largest size of each dimension, gathered once, and trimmed
    back, as the reference's ``gather_all_tensors`` does. One shape exchange
    and one data gather.
    """
    if not in_group():
        return [x]
    device = x.device if x is not None else (device or default_device())
    shapes, dtype = _exchange_shapes(x, device)
    present = [s for s in shapes if s is not None]
    if not present:
        return [None] * len(shapes)
    top = tuple(max(dims) for dims in zip(*present))
    buf = torch.zeros(top, dtype=dtype, device=device)
    if x is not None:
        buf[tuple(slice(0, d) for d in x.shape)] = x
    gathered = _all_gather_list(buf, "all_gather")
    return [None if s is None else g[tuple(slice(0, d) for d in s)] for g, s in zip(gathered, shapes)]


def sync_leaf(
    reduce: Union[Reduce, Callable],
    value: Union[Tensor, ListState],
    device: Optional[torch.device] = None,
) -> Union[Tensor, ListState]:
    """Cross-process combine of one leaf over the default process group.

    sum/max/min are one ``all_reduce``; mean is a sum divided by the world
    size (a true divide: an int32 leaf comes back float32, as JAX's
    ``pmean``); cat gathers uneven first dims and concatenates in rank
    order (a list state: each rank's items concatenated, gathered once, back
    as a one-tensor tuple, or ``()`` where no rank holds an item); none
    stacks the ranks' copies (per element of a list state, whose ranks must
    hold as many items); a callable reduces the stacked copies. A sketch with
    a ``bucket_op`` is one ``all_reduce`` of that op; a structural sketch is
    one fixed-shape ``all_gather`` (every rank's leaf has the spec's shape, so
    no shape exchange) and its ``combine_stacked``. ``device`` places the
    collective of a list state that holds no item on this rank.
    """
    reduce = canonical_reduce(reduce)
    if isinstance(reduce, SketchReduce):
        if reduce.bucket_op is not None:
            return all_reduce(value, reduce.bucket_op)
        copies = _all_gather_list(value, "all_gather") if in_group() else [value]
        return reduce.combine_stacked(torch.stack(copies))
    if isinstance(value, tuple):
        device = value[0].device if value else device
        if reduce == Reduce.CAT:
            local = torch.cat([torch.atleast_1d(v) for v in value]) if value else None
            parts = [p for p in gather_all_tensors(local, device) if p is not None]
            return (torch.cat(parts),) if parts else ()
        if reduce == Reduce.NONE:
            return tuple(torch.stack(gather_all_tensors(v)) for v in value)
        raise ValueError(f"list state leaves combine by cat or none, not {reduce!r}")
    if callable(reduce) and not isinstance(reduce, Reduce):
        return reduce(torch.stack(gather_all_tensors(value)))
    if reduce in (Reduce.SUM, Reduce.MAX, Reduce.MIN):
        return all_reduce(value, reduce.value)
    if reduce == Reduce.MEAN:
        return all_reduce(value, "sum") / world_size()
    if reduce == Reduce.CAT:
        return torch.cat([torch.atleast_1d(v) for v in gather_all_tensors(value)])
    if reduce == Reduce.NONE:
        return torch.stack(gather_all_tensors(value))
    raise ValueError(f"Unknown reduction {reduce}")
