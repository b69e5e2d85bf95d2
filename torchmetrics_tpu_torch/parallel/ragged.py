"""Ragged (variable-length) list-state sync (counterpart of ``torchmetrics_tpu/parallel/ragged.py``).

Detection mAP keeps one tensor per image, ROUGE one score vector per
update: each rank holds a different number of items of different shapes.
The JAX package gathers every device's items inside one program; here each
rank calls :func:`sync_ragged_states` on its own state, and the ranks:

1. gather every rank's shape table (item count and shapes per leaf) in one
   small uneven gather;
2. pad each local item to the per-leaf maximum of every dimension over all
   ranks, and pack the items of a leaf into one buffer of ``L`` rows, ``L``
   the largest row count of any rank;
3. ravel the buffers of every leaf of one wire type, in sorted-name order,
   into one segment a rank and gather it once (one ``all_gather`` per
   dtype, however many list leaves the state holds);
4. trim and re-split in rank order, so every rank's items, and their count,
   come back as they were.

An integer leaf whose ``value_ranges`` entry fits a narrower type travels
as that type (detection labels in ``[0, 90]`` as ``uint8``) and is cast
back after the trim; values outside the declared range raise. Tensor
leaves and the ``_n`` counter sync through the coalescing planner. Re-split
items come back as CPU tensors, as the JAX package returns host numpy.

``route="two_stage"`` follows the gather with ONE exchange of the gathered
copy through ``dcn_allgather`` across ``n_processes`` processes (JAX's
per-host stage over DCN). ``torch.distributed``'s default group already
spans every process, so by default ``n_processes`` is 1 and both routes are
the same; pass both where the default group is one host's ranks.
:class:`DeferredRaggedSync` folds each step into this rank's running state
and gathers once, at compute, for one or several registered metrics;
:func:`sharded_list_update` is one update and its sync.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.core.reductions import Reduce
    >>> from torchmetrics_tpu_torch.parallel import sync_ragged_states
    >>> state = {"items": (torch.ones(2), torch.zeros(3)), "_n": torch.tensor(1, dtype=torch.int32)}
    >>> out = sync_ragged_states({"items": Reduce.CAT}, state)  # one rank
    >>> [tuple(v.shape) for v in out["items"]], int(out["_n"])
    ([(2,), (3,)], 1)
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.reductions import (
    _DTYPES,
    Reduce,
    SketchReduce,
    _all_gather_list,
    default_device,
    gather_all_tensors,
    in_group,
    world_size,
)
from torchmetrics_tpu_torch.parallel.coalesce import _own_sync, coalesced_sync_state
from torchmetrics_tpu_torch.parallel.compress import packed_int_dtype

__all__ = ["DeferredRaggedSync", "GATHER_ROUTES", "packed_int_dtype", "sharded_list_update", "sync_ragged_states"]

State = Dict[str, Any]
_N = "_n"

#: gather routes: ``"flat"`` is one gather over the default group; ``"two_stage"`` adds one exchange of the
#: gathered copy a process through ``dcn_allgather``
GATHER_ROUTES = ("flat", "two_stage")


def _host_combine(reduce: Any, gathered: Tensor) -> Tensor:
    """One leaf's reduction over its processes' stacked ``(n_processes, ...)`` copies (the two-stage route's
    second stage)."""
    if isinstance(reduce, SketchReduce):
        if reduce.bucket_op == "sum":
            return gathered.sum(0, dtype=gathered.dtype)
        if reduce.bucket_op == "max":
            return gathered.amax(0)
        if reduce.bucket_op == "min":
            return gathered.amin(0)
        return reduce.combine_stacked(gathered)
    if callable(reduce) and not isinstance(reduce, Reduce):
        return reduce(gathered)
    if reduce == Reduce.SUM:
        return gathered.sum(0, dtype=gathered.dtype)
    if reduce == Reduce.MEAN:
        return gathered.to(torch.float32).mean(0) if not gathered.is_floating_point() else gathered.mean(0)
    if reduce == Reduce.MAX:
        return gathered.amax(0)
    if reduce == Reduce.MIN:
        return gathered.amin(0)
    raise ValueError(
        f"two-stage DCN exchange cannot combine scalar reduction {reduce!r}; "
        "gather-family leaves cross as flat buffers, not scalars"
    )


def _pack_items(items: Sequence[Tensor], rows: int, trailing: Tuple[int, ...], dtype: torch.dtype,
                device: torch.device) -> Tensor:
    """This rank's items padded to ``trailing`` and stacked along the leading
    axis into a ``(rows, *trailing)`` buffer of ``dtype`` (zeros beyond)."""
    buf = torch.zeros((rows, *trailing), dtype=dtype, device=device)
    if items and all(tuple(it.shape[1:]) == trailing for it in items):
        cat = torch.cat(list(items))
        buf[: cat.shape[0]] = cat  # one copy where no item needs padding
        return buf
    offset = 0
    for it in items:
        buf[(slice(offset, offset + it.shape[0]),) + tuple(slice(0, d) for d in it.shape[1:])] = it
        offset += it.shape[0]
    return buf


def _ragged_meta(tables: Sequence[Tuple[int, Sequence[Tuple[int, ...]]]], name: str):
    """``(elementwise max trailing shape, dtype)`` over every rank's items of
    one leaf, or ``None`` if no rank holds an item. ``tables`` holds each
    rank's ``(dtype code, item shapes)``."""
    trailing: Optional[List[int]] = None
    code = None
    for dtype_code, shapes in tables:
        for shape in shapes:
            if trailing is None:
                trailing, code = list(shape[1:]), dtype_code
                continue
            if len(shape) != len(trailing) + 1:
                raise ValueError(
                    f"ragged list-state items of {name!r} must share rank: {len(shape)}d vs {len(trailing) + 1}d"
                )
            if dtype_code != code:
                raise ValueError(
                    f"ragged list-state items of {name!r} must share dtype: {_DTYPES[dtype_code]} vs {_DTYPES[code]} "
                    "(a silent cast would diverge from single-process accumulation)"
                )
            trailing = [max(a, b) for a, b in zip(trailing, shape[1:])]
    return None if trailing is None else (tuple(trailing), _DTYPES[code])


def _check_update_counts(counts: Sequence[int], leaf: str = _N) -> None:
    """Raise :class:`ReplicaDivergenceError` if the ranks' update counts disagree."""
    if len(set(counts)) > 1:
        from torchmetrics_tpu_torch.utilities.exceptions import ReplicaDivergenceError

        majority = max(set(counts), key=list(counts).count)
        bad = [d for d, c in enumerate(counts) if c != majority]
        raise ReplicaDivergenceError(
            f"per-rank update counts diverged before ragged sync: {list(counts)} "
            f"(ranks {bad} disagree with the majority count {majority}). Each rank "
            "must see the same number of update steps.",
            leaves=(leaf,),
            replicas=bad,
        )


def _check_value_range(per_rank: Sequence[Tuple[int, int]], name: str, value_range: Tuple[float, float]) -> None:
    """Raise if any rank's items of a bitpacked leaf fall outside its declared
    range (the narrowing cast would wrap them). ``per_rank`` holds each rank's
    ``(min, max)`` from the shape exchange, so every rank raises alike."""
    lo, hi = value_range
    for rank, (vmin, vmax) in enumerate(per_rank):
        if vmin < lo or vmax > hi:
            raise ValueError(
                f"ragged leaf {name!r} on rank {rank} holds values in [{vmin}, {vmax}] outside its "
                f"declared value_range ({lo}, {hi}); the bitpacked gather would wrap them."
            )


def _shape_table(names: Sequence[str], state: State, ranged: Sequence[str]) -> Tensor:
    """This rank's shape table as one int64 vector: per leaf, in ``names``
    order, ``[item count, item rank, dtype code, min, max, *shapes]``; min and
    max are those of the items of an integer leaf named in ``ranged`` (else 0)."""
    table: List[int] = []
    for name in names:
        items = state[name]
        ndim = items[0].ndim if items else 0
        lo = hi = 0
        if name in ranged and items and not items[0].is_floating_point():
            values = torch.cat([it.reshape(-1) for it in items])
            if values.numel():
                lo, hi = int(values.min()), int(values.max())
        table += [len(items), ndim, _DTYPES.index(items[0].dtype) if items else 0, lo, hi]
        for it in items:
            if it.ndim != ndim:
                raise ValueError(f"ragged list-state items of {name!r} must share rank: {it.ndim}d vs {ndim}d")
            table += list(it.shape)
    return torch.tensor(table, dtype=torch.int64)


def _parse_table(table: Tensor, names: Sequence[str]) -> Dict[str, Tuple[int, List[Tuple[int, ...]], Tuple[int, int]]]:
    """``{leaf: (dtype code, item shapes, (min, max))}`` of one rank's table."""
    values = table.tolist()
    out, pos = {}, 0
    for name in names:
        count, ndim, code, lo, hi = values[pos : pos + 5]
        pos += 5
        shapes = [tuple(values[pos + i * ndim : pos + (i + 1) * ndim]) for i in range(count)]
        pos += count * ndim
        out[name] = (code, shapes, (lo, hi))
    return out


def _rank_table(shapes: Sequence[Tuple[int, ...]], count: int, ndim: int) -> Tensor:
    """A rank's ``(count, ndim)`` int64 table of item shapes, rows past its items -1."""
    tab = torch.full((count, ndim), -1, dtype=torch.int64)
    if shapes:
        tab[: len(shapes)] = torch.tensor(shapes, dtype=torch.int64).reshape(len(shapes), ndim)
    return tab


def sync_ragged_states(
    reductions: Mapping[str, Union[Reduce, Callable]],
    state: State,
    value_ranges: Optional[Mapping[str, Tuple[float, float]]] = None,
    verify_consistency: bool = False,
    route: str = "flat",
    owner: Any = None,
    n_processes: Optional[int] = None,
    dcn_allgather: Optional[Callable[[Any], Any]] = None,
) -> State:
    """Combine this rank's state, whose list leaves are ragged, with every other rank's.

    Every rank calls it with a state of the same leaves. List leaves (tuples
    of items under cat, none or a callable) come back as tuples of every
    rank's items in rank order, on the CPU; tensor leaves and ``_n`` are
    synced under the reduction table. ``verify_consistency=True`` first
    checks that every rank counted the same number of updates.

    ``route="two_stage"`` with ``n_processes > 1`` exchanges the gathered
    copy once more through ``dcn_allgather`` (a tensor -> the processes'
    copies stacked, ``(n_processes, *shape)``): the gathered buffers
    concatenate process after process, extending rank order, and tensor
    leaves and ``_n`` are reduced again over the processes. ``owner`` is
    accepted; JAX records the gather in its telemetry registry while that is
    enabled (off by default), and the port has no registry yet, so it
    records nothing.
    """
    if route not in GATHER_ROUTES:
        raise ValueError(f"Arg `route` must be one of {GATHER_ROUTES}, got {route!r}")
    n_proc = (1 if n_processes is None else int(n_processes)) if route == "two_stage" else 1
    if n_proc > 1 and dcn_allgather is None:
        raise ValueError(
            "route='two_stage' with n_processes > 1 needs dcn_allgather: the default process group already "
            "spans every process, so the second stage has no default exchange"
        )
    device = next((v.device for v in state.values() if isinstance(v, Tensor)),
                  next((v[0].device for v in state.values() if isinstance(v, tuple) and v), default_device()))
    if verify_consistency:
        count = state[_N].reshape(1).to(torch.int64) if _N in state else torch.zeros(1, dtype=torch.int64)
        _check_update_counts([int(c) for c in gather_all_tensors(count.to(device))])
    scalar_names: List[str] = []
    ragged_names: List[str] = []
    for name in state:
        if name == _N:
            continue
        reduce = reductions.get(name)
        if reduce is None:
            raise ValueError(
                f"state leaf {name!r} has no entry in the reduction table "
                f"(known: {sorted(reductions)}); cannot classify it for ragged sync"
            )
        if isinstance(state[name], tuple):
            if reduce not in (Reduce.CAT, Reduce.NONE) and not callable(reduce):
                raise ValueError(
                    f"state leaf {name!r} holds item tuples but its reduction is {reduce!r}; "
                    "only cat/None (or callable) reductions combine list states"
                )
            ragged_names.append(name)
        else:
            scalar_names.append(name)

    sub = {name: state[name] for name in scalar_names}
    if _N in state:
        sub[_N] = state[_N]
    out: State = coalesced_sync_state(sub, reductions) if sub else {}
    if n_proc > 1:
        for name in list(out):
            copies = torch.as_tensor(dcn_allgather(out[name]), device=out[name].device)
            out[name] = copies.sum(0, dtype=copies.dtype) if name == _N else _host_combine(reductions[name], copies)
    if not ragged_names:
        return out

    ragged_names.sort()
    value_ranges = value_ranges or {}
    local = _shape_table(ragged_names, state, list(value_ranges))
    tables = [_parse_table(t.cpu(), ragged_names) for t in gather_all_tensors(local.to(device))]
    layout: Dict[str, Tuple[Tuple[int, ...], torch.dtype, int, int]] = {}  # name -> (trailing, dtype, L, K)
    by_wire: Dict[torch.dtype, List[str]] = {}
    for name in ragged_names:
        per_rank = [t[name][:2] for t in tables]
        meta = _ragged_meta(per_rank, name)
        if meta is None:  # no rank holds an item of this leaf
            out[name] = ()
            continue
        trailing, dtype = meta
        rows = max(sum(s[0] for s in shapes) for _, shapes in per_rank)
        wire = packed_int_dtype(dtype, value_ranges[name]) if name in value_ranges else dtype
        if wire != dtype:
            _check_value_range([t[name][2] for t in tables if t[name][1]], name, value_ranges[name])
        layout[name] = (trailing, dtype, rows, max(len(shapes) for _, shapes in per_rank))
        by_wire.setdefault(wire, []).append(name)
    if not layout:
        return out

    # one gather per wire type: this rank's buffers of the group's leaves, raveled side by side
    flats: Dict[torch.dtype, Tensor] = {}
    for wire, group in sorted(by_wire.items(), key=lambda kv: str(kv[0])):
        seg = torch.cat([_pack_items(state[nm], layout[nm][2], layout[nm][0], layout[nm][1], device).to(wire)
                         .reshape(-1) for nm in group])
        gathered = _all_gather_list(seg, "all_gather") if in_group() else [seg]
        flats[wire] = torch.cat([g.cpu() for g in gathered])
    names = sorted(layout)
    copies = [{nm: t[nm][1] for nm in names} for t in tables]  # each gathered copy's item shapes a leaf
    if n_proc > 1:  # stage 2: the gathered copy once more, process after process
        flats = {w: torch.as_tensor(dcn_allgather(f)).reshape(-1) for w, f in flats.items()}
        copies = _exchange_shapes(copies, names, layout, n_proc, dcn_allgather)

    items: Dict[str, List[Tensor]] = {nm: [] for nm in names}
    for wire, group in by_wire.items():
        sizes = [layout[nm][2] * math.prod(layout[nm][0]) for nm in group]
        seg_len = sum(sizes)
        for d, shapes_of in enumerate(copies):
            off = d * seg_len
            for nm, size in zip(group, sizes):
                trailing, dtype, rows, _ = layout[nm]
                block = flats[wire][off : off + size].reshape(rows, *trailing).to(dtype)
                off += size
                lead = 0
                for shape in shapes_of[nm]:
                    items[nm].append(block[(slice(lead, lead + shape[0]),) + tuple(slice(0, s) for s in shape[1:])])
                    lead += shape[0]
    for nm in names:
        out[nm] = tuple(items[nm])
    return out


def _exchange_shapes(copies: List[Dict[str, List[Tuple[int, ...]]]], names: List[str], layout: Mapping[str, Tuple],
                     n_proc: int, dcn_allgather: Callable[[Any], Any]) -> List[Dict[str, List[Tuple[int, ...]]]]:
    """The two-stage route's shape tables: this process's copies encoded as padded ``(count, ndim)`` tables,
    exchanged through ``dcn_allgather`` and decoded, process after process."""
    ndims = {nm: 1 + len(layout[nm][0]) for nm in names}
    flat = torch.cat([_rank_table(c[nm], layout[nm][3], ndims[nm]).reshape(-1) for c in copies for nm in names])
    flat = torch.as_tensor(dcn_allgather(flat)).reshape(-1)
    out, pos = [], 0
    for _ in range(len(copies) * n_proc):
        copy = {}
        for nm in names:
            size = layout[nm][3] * ndims[nm]
            tab = flat[pos : pos + size].reshape(layout[nm][3], ndims[nm]).tolist()
            copy[nm] = [tuple(row) for row in tab if row[0] >= 0]
            pos += size
        out.append(copy)
    return out


def sharded_list_update(metric: Any, *inputs: Any, **kwargs: Any) -> State:
    """One update of a list-state metric on this rank's (possibly ragged) batch, then the ragged sync: the
    list-state counterpart of :func:`~torchmetrics_tpu_torch.parallel.sync.sharded_update`. Returns the synced
    state, ready for ``compute_state``. A metric that overrides ``sync_states`` is refused: its states do not
    combine leaf by leaf under the reduction table."""
    if _own_sync(metric):
        raise ValueError(
            f"{type(metric).__name__} overrides sync_states, so its states do not combine "
            "leaf-wise under the reduction table. Use sharded_update (tensor states) or sync "
            "its states with the metric's own sync_states."
        )
    state = metric.update_state(metric.init_state(), *inputs, **kwargs)
    return sync_ragged_states(metric._reductions, state, value_ranges=getattr(metric, "_value_ranges", None),
                              owner=metric)


class DeferredRaggedSync:
    """This rank's steps accumulated locally, the list-state gather deferred to ``compute``: once an
    evaluation instead of once a step.

    Several list-state metrics of one evaluation loop can :meth:`register` on
    the same accumulator: their leaves are namespaced (``"name::leaf"``) into
    one combined state, so :meth:`sync` runs one gather per dtype for all of
    them. Every rank must call :meth:`sync` (or :meth:`compute`) together.

    Example::

        shared = DeferredRaggedSync()
        shared.register(map_metric, "map")
        shared.register(rouge_metric, "rouge")
        for preds, target, hyps, refs in loader:   # this rank's batches
            shared.update_for("map", preds, target)    # no collective
            shared.update_for("rouge", hyps, refs)
        results = shared.compute()                 # ONE gather per dtype for both
    """

    def __init__(
        self,
        metric: Optional[Any] = None,
        verify_consistency: bool = False,
        route: str = "flat",
        n_processes: Optional[int] = None,
        dcn_allgather: Optional[Callable[[Any], Any]] = None,
    ) -> None:
        if route not in GATHER_ROUTES:
            raise ValueError(f"Arg `route` must be one of {GATHER_ROUTES}, got {route!r}")
        self.verify_consistency = verify_consistency
        self.route = route
        self.n_processes = n_processes
        self.dcn_allgather = dcn_allgather
        self._members: Dict[str, Any] = {}  # insertion-ordered
        self._local: Dict[str, Optional[State]] = {}
        if metric is not None:
            self.register(metric)

    def set_route(self, route: str) -> str:
        """Switch the gather route of later syncs; returns the previous one. Accumulated states are kept."""
        if route not in GATHER_ROUTES:
            raise ValueError(f"Arg `route` must be one of {GATHER_ROUTES}, got {route!r}")
        previous, self.route = self.route, route
        return previous

    def register(self, metric: Any, name: Optional[str] = None) -> str:
        """Add a metric to the shared gather; returns its key. Registering the same metric under its name
        again is a no-op; a different metric under a taken name raises."""
        if _own_sync(metric):
            raise ValueError(
                f"{type(metric).__name__} overrides sync_states; its states do not combine "
                "leaf-wise under the reduction table, so the deferred gather cannot apply it."
            )
        if name is None:
            name = type(metric).__name__
            if name in self._members and self._members[name] is not metric:
                name = f"{name}_{len(self._members)}"
        if name in self._members:
            if self._members[name] is metric:
                return name
            raise ValueError(
                f"a different {type(self._members[name]).__name__} is already registered "
                f"under {name!r}; pass an explicit unique name (re-registering the SAME "
                "metric object is a no-op, but two metrics cannot share a telemetry owner name)"
            )
        if "::" in name:
            raise ValueError(f"metric name {name!r} may not contain '::' (the namespace separator)")
        self._members[name] = metric
        self._local[name] = None
        return name

    @property
    def metric(self) -> Any:
        """The sole registered metric."""
        if len(self._members) != 1:
            raise AttributeError(f".metric needs exactly one registered metric, have {len(self._members)}")
        return next(iter(self._members.values()))

    def _sole_key(self, what: str) -> str:
        if len(self._members) != 1:
            raise RuntimeError(
                f"{what} requires exactly one registered metric "
                f"(have {sorted(self._members)}); use the *_for/keyed variants"
            )
        return next(iter(self._members))

    @property
    def steps(self) -> int:
        state = self._local[self._sole_key("steps")]
        return 0 if state is None else int(state[_N])

    def update(self, *inputs: Any, **kwargs: Any) -> None:
        """Fold this rank's batch into its running state; no collective."""
        self.update_for(self._sole_key("update"), *inputs, **kwargs)

    def update_for(self, name: str, *inputs: Any, **kwargs: Any) -> None:
        """:meth:`update` of one registered metric."""
        if name not in self._members:
            raise KeyError(f"no metric registered under {name!r} (have {sorted(self._members)})")
        m = self._members[name]
        partial = m.update_state(m.init_state(), *inputs, **kwargs)
        self._local[name] = partial if self._local[name] is None else m.merge_states(self._local[name], partial)

    def _sync_kwargs(self) -> Dict[str, Any]:
        return {"route": self.route, "n_processes": self.n_processes, "dcn_allgather": self.dcn_allgather}

    def sync(self) -> Union[State, Dict[str, State]]:
        """The deferred gather: the one metric's synced state, or ``{name: state}`` of every registered
        metric, all in one gather per dtype."""
        if not self._members:
            raise RuntimeError("DeferredRaggedSync.sync called with no registered metric")
        never = [k for k, v in self._local.items() if v is None]
        if never:
            raise RuntimeError(f"DeferredRaggedSync.sync called before any update for {never}")
        if len(self._members) == 1:
            key = next(iter(self._members))
            m = self._members[key]
            return sync_ragged_states(m._reductions, self._local[key], value_ranges=getattr(m, "_value_ranges", None),
                                      verify_consistency=self.verify_consistency, owner=m, **self._sync_kwargs())
        if self.verify_consistency:
            for key, state in self._local.items():
                count = state[_N].reshape(1).to(torch.int64)
                _check_update_counts([int(c) for c in gather_all_tensors(count)], leaf=f"{key}::{_N}")
        table: Dict[str, Any] = {}
        ranges: Dict[str, Tuple[float, float]] = {}
        combined: State = {}
        for key, m in self._members.items():
            table.update({f"{key}::{leaf}": r for leaf, r in m._reductions.items()})
            ranges.update({f"{key}::{leaf}": rng for leaf, rng in getattr(m, "_value_ranges", {}).items()})
            table[f"{key}::{_N}"] = Reduce.SUM  # the counters become namespaced SUM leaves
            combined.update({f"{key}::{leaf}": v for leaf, v in self._local[key].items()})
        synced = sync_ragged_states(table, combined, value_ranges=ranges, **self._sync_kwargs())
        out: Dict[str, State] = {}
        for key in self._members:
            prefix = f"{key}::"
            out[key] = {leaf[len(prefix):]: v for leaf, v in synced.items() if leaf.startswith(prefix)}
        return out

    def compute(self) -> Any:
        """The one metric's value, or ``{name: value}``."""
        if len(self._members) == 1:
            return self.metric.compute_state(self.sync())
        synced = self.sync()
        return {key: self._members[key].compute_state(synced[key]) for key in self._members}

    def reset(self) -> None:
        self._local = {key: None for key in self._members}

    def reset_for(self, name: str) -> None:
        """Drop one member's accumulated state; the others keep theirs."""
        if name not in self._members:
            raise KeyError(f"no metric registered under {name!r} (have {sorted(self._members)})")
        self._local[name] = None
