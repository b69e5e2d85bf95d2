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
3. gather each list leaf once (one ``all_gather`` per state name);
4. trim and re-split in rank order, so every rank's items, and their count,
   come back as they were.

An integer leaf whose ``value_ranges`` entry fits a narrower type travels
as that type (detection labels in ``[0, 90]`` as ``uint8``) and is cast
back after the trim; values outside the declared range raise. Tensor
leaves and the ``_n`` counter sync through the coalescing planner. Re-split
items come back as CPU tensors, as the JAX package returns host numpy.

Not ported yet, and refused: ``route="two_stage"``, ``n_processes``,
``dcn_allgather``, ``owner`` (telemetry); ``DeferredRaggedSync`` and
``sharded_list_update``.

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

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.reductions import (
    _DTYPES,
    Reduce,
    _all_gather_list,
    default_device,
    gather_all_tensors,
    in_group,
)
from torchmetrics_tpu_torch.parallel.coalesce import coalesced_sync_state

State = Dict[str, Any]
_N = "_n"

#: integer types a bitpacked leaf may travel as, narrowest first; each is
#: one that NCCL and gloo both gather
_PACK_CANDIDATES = (torch.uint8, torch.int8, torch.int32)


def packed_int_dtype(dtype: torch.dtype, value_range: Tuple[float, float]) -> torch.dtype:
    """The narrowest integer type that holds a declared ``(lo, hi)``;
    ``dtype`` itself for float leaves or when nothing narrower fits."""
    if dtype.is_floating_point or dtype == torch.bool:
        return dtype
    lo, hi = value_range
    width = torch.iinfo(dtype).bits
    for cand in _PACK_CANDIDATES:
        info = torch.iinfo(cand)
        if info.bits < width and info.min <= lo and hi <= info.max:
            return cand
    return dtype


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
    """
    if route != "flat" or owner is not None or n_processes is not None or dcn_allgather is not None:
        raise NotImplementedError(
            "sync_ragged_states: route='two_stage', owner, n_processes and dcn_allgather are not ported yet"
        )
    device = state[_N].device if _N in state else default_device()
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
    if not ragged_names:
        return out

    ragged_names.sort()
    value_ranges = value_ranges or {}
    local = _shape_table(ragged_names, state, list(value_ranges))
    tables = [_parse_table(t.cpu(), ragged_names) for t in gather_all_tensors(local.to(device))]
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
        buf = _pack_items(state[name], rows, trailing, dtype, device).to(wire)
        gathered = _all_gather_list(buf, "all_gather") if in_group() else [buf]
        items: List[Tensor] = []
        for g, (_, shapes) in zip(gathered, per_rank):
            g = g.cpu().to(dtype)
            offset = 0
            for shape in shapes:
                items.append(g[(slice(offset, offset + shape[0]),) + tuple(slice(0, d) for d in shape[1:])])
                offset += shape[0]
        out[name] = tuple(items)
    return out
