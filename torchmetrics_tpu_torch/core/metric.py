"""``Metric``, the core runtime (counterpart of ``torchmetrics_tpu/core/metric.py``).

As in the JAX package, the functional core is primary and the stateful API
is a thin eager facade over it:

functional core (returns new states; only the multiclass confusion-matrix
family writes into the state it is given, see ``update_state``):
    ``init_state() -> State``
    ``update_state(state, *inputs) -> State``
    ``compute_state(state) -> result``
    ``merge_states(a, b) -> State``
    ``sync_states(state) -> State`` (over ``torch.distributed``'s default group)

A SUM tensor leaf may be sharded over the ranks (``add_state(state_sharding=...)``
or :meth:`Metric.set_state_sharding`): its sync is one ``reduce_scatter``
and each rank keeps its block of the sum. ``compute_state`` on a synced
state then gathers the blocks (one ``all_gather`` a sharded leaf), so in a
world of several ranks it is a collective that every rank must call; its
value equals, bit for bit, the compute on the replicated sync.

facade:
    ``update / compute / forward / reset / clone / state_dict / load_state_dict``

State is a dict ``{name: Tensor | tuple[Tensor, ...]}`` plus the reserved
int32 ``"_n"`` update counter. ``Metric`` is a plain class, not an
``nn.Module``: ``state_dict`` holds only the persistent leaves, as in the
JAX package, which a module's buffer registry would not keep to.

A metric lives on one device, CUDA unless the caller passes another one:
``Metric()`` on a machine without CUDA raises instead of running on the CPU.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
    >>> metric = MulticlassAccuracy(num_classes=3, average="micro", device="cpu")
    >>> metric.update(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 2, 2]))
    >>> round(float(metric.compute()), 4)
    0.75
"""

from __future__ import annotations

import inspect
from copy import deepcopy
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.reductions import (
    Reduce,
    ShardSpec,
    SketchReduce,
    all_gather_rows,
    canonical_reduce,
    canonical_sharding,
    merge_leaf,
    world_size,
)
from torchmetrics_tpu_torch.utilities.data import resolve_device, to_tensor
from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

State = Dict[str, Any]

_N = "_n"  # reserved state key: int32 update counter, sum-merged

# ctor kwargs of the JAX base that drive sync, compilation or non-finite
# guards; this port has none of them yet, so each is refused
UNPORTED_BASE_KWARGS = frozenset(
    {
        "sync_on_compute",
        "dist_sync_on_step",
        "axis_name",
        "jit",
        "nan_strategy",
        "dist_sync_fn",
        "distributed_available_fn",
        "process_group",
        "compute_on_cpu",
    }
)

# every ctor kwarg of the base, the refused ones too: wrappers that forward leftover kwargs elsewhere
# (``PermutationInvariantTraining``) split on this set
METRIC_BASE_KWARGS = frozenset({"device", "compute_with_cache", "approx", "approx_error"}) | UNPORTED_BASE_KWARGS

#: approximation modes a metric may opt into: ``"sketch"`` replaces cat states
#: with fixed-shape mergeable summaries (histograms, HyperLogLog registers),
#: ``"reservoir"`` keeps a deterministic bottom-k-by-hash corpus sample
APPROX_MODES = (None, "sketch", "reservoir")


def _validate_approx(approx: Optional[str], approx_error: Optional[float]) -> Tuple[Optional[str], Optional[float]]:
    """Shared ctor/``set_approx`` validation of the approximation config."""
    if approx not in APPROX_MODES:
        raise ValueError(f"Arg `approx` must be None, 'sketch' or 'reservoir', got {approx!r}")
    if approx_error is not None:
        if approx is None:
            raise ValueError("`approx_error` requires `approx='sketch'` or `approx='reservoir'`")
        approx_error = float(approx_error)
        if not (0.0 < approx_error <= 0.5):
            raise ValueError(f"`approx_error` must be in (0, 0.5], got {approx_error}")
    return approx, approx_error


def _copy_shared(value: Any, storages: set) -> Any:
    """``value`` with every tensor in it that lives in one of ``storages`` copied."""
    if isinstance(value, Tensor):
        return value.clone() if value.untyped_storage().data_ptr() in storages else value
    if isinstance(value, (list, tuple)):
        return type(value)(_copy_shared(v, storages) for v in value)
    if isinstance(value, dict):
        return {k: _copy_shared(v, storages) for k, v in value.items()}
    return value


def _move(value: Any, device: torch.device) -> Any:
    if isinstance(value, tuple):
        return tuple(v.to(device) for v in value)
    return value.to(device)


class Metric:
    """Base class for all metrics.

    Args:
        device: where the state lives and the update runs; ``None`` means
            the current CUDA device.
        compute_with_cache: cache the ``compute`` result until the next
            update or reset.
        approx: ``None`` (exact states), ``"sketch"`` or ``"reservoir"``:
            the metric families with a sketch layout (the curve family,
            calibration error, mAP, DistinctNGrams; the reservoir of BLEU,
            SacreBLEU and ROUGE) replace their unbounded states with
            fixed-size mergeable sketches (``torchmetrics_tpu_torch.sketches``);
            every other metric takes the argument and computes exactly.
        approx_error: the target error bound of ``approx`` (each sketch
            documents what it bounds); ``None`` picks the sketch's default.
    """

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = False

    #: tensor attributes besides the state that live on the metric's device
    _device_attrs: Tuple[str, ...] = ()

    #: state leaves that ``_update`` adds into in place (the multiclass
    #: confusion matrix); every reader that hands out a state tensor copies them
    _inplace_leaves: Tuple[str, ...] = ()

    #: a subclass that takes ``nan_strategy`` itself (the aggregators); the
    #: base refuses the kwarg for every other metric
    __handles_nan_strategy__: bool = False

    def __init__(self, device: Optional[Union[str, torch.device]] = None, **kwargs: Any) -> None:
        refused = UNPORTED_BASE_KWARGS - ({"nan_strategy"} if type(self).__handles_nan_strategy__ else set())
        unported = sorted(refused & kwargs.keys())
        if unported:
            raise ValueError(f"Metric arguments {unported} are not supported by the PyTorch port yet")
        self.compute_with_cache: bool = kwargs.pop("compute_with_cache", True)
        approx, approx_error = kwargs.pop("approx", None), kwargs.pop("approx_error", None)
        self.approx, self.approx_error = _validate_approx(approx, approx_error)
        if kwargs:
            raise ValueError(f"Unexpected keyword arguments: {list(kwargs)}")
        self.device = resolve_device(device)
        self._defaults: Dict[str, Any] = {}
        self._reductions: Dict[str, Union[Reduce, Callable, SketchReduce]] = {}
        self._persistent: Dict[str, bool] = {}
        self._value_ranges: Dict[str, Tuple[float, float]] = {}
        #: the sharding spec of each sharded SUM tensor leaf
        self._state_shardings: Dict[str, ShardSpec] = {}
        self._state: State = {_N: self._zero_count()}
        self._computed: Any = None
        self._forward_cache: Any = None

    def _zero_count(self) -> Tensor:
        return torch.zeros((), dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------------ state
    def add_state(
        self,
        name: str,
        default: Union[Tensor, np.ndarray, int, float, list, Sequence],
        dist_reduce_fx: Optional[Union[str, Callable, SketchReduce]] = None,
        persistent: bool = False,
        value_range: Optional[Tuple[float, float]] = None,
        state_sharding: Optional[Union[str, ShardSpec]] = None,
    ) -> None:
        """Register a state leaf.

        ``default`` is a tensor (tensor state) or an empty list (list state,
        stored as a tuple of tensors). ``dist_reduce_fx`` is one of
        sum|mean|max|min|cat, a callable, a
        :class:`~torchmetrics_tpu_torch.core.reductions.SketchReduce` spec
        for a fixed-shape sketch leaf, or None. ``value_range=(lo, hi)``
        declares the values the leaf can hold. ``state_sharding``
        (``"replicated"``, the default, ``"sharded"`` or a
        :class:`~torchmetrics_tpu_torch.core.reductions.ShardSpec`) shards a
        SUM tensor leaf over the ranks: its sync is one ``reduce_scatter`` and
        each rank keeps its block until ``compute_state`` gathers.
        """
        if name.startswith("_"):
            raise ValueError(f"State name {name!r} must not start with '_'")
        if value_range is not None:
            try:
                lo, hi = float(value_range[0]), float(value_range[1])
                ok = len(value_range) == 2 and lo <= hi
            except (TypeError, ValueError, IndexError):
                ok = False
            if not ok:
                raise ValueError(f"value_range must be a (lo, hi) pair with lo <= hi, got {value_range!r}")
            self._value_ranges[name] = (lo, hi)
        if isinstance(default, (list, tuple)):
            if len(default) != 0:
                raise ValueError("list-type state must start empty")
            self._defaults[name] = ()
            self._state[name] = ()
        elif isinstance(default, (Tensor, np.ndarray, int, float)):
            arr = to_tensor(default, self.device)
            self._defaults[name] = arr
            self._state[name] = arr.clone()
        else:
            raise ValueError("state variable must be a tensor or an empty list")
        self._reductions[name] = canonical_reduce(dist_reduce_fx)
        self._persistent[name] = persistent
        spec = canonical_sharding(state_sharding)
        if spec is not None:
            self._install_sharding(name, spec)

    def _install_sharding(self, name: str, spec: ShardSpec) -> None:
        """Check and install one leaf's :class:`ShardSpec`, with JAX's refusals."""
        reduce = self._reductions.get(name)
        if reduce is not Reduce.SUM:
            raise ValueError(
                f"state_sharding requires dist_reduce_fx='sum' (leaf {name!r} has "
                f"{reduce!r}): only sum-family leaves have a zero identity the "
                "reduce-scatter padding and quarantine masking rely on"
            )
        default = self._defaults[name]
        if isinstance(default, tuple):
            raise ValueError(f"state_sharding does not apply to list (cat) state {name!r}")
        if spec.axis >= default.ndim:
            raise ValueError(
                f"ShardSpec.axis={spec.axis} out of range for state {name!r} with shape {tuple(default.shape)}"
            )
        if type(self).sync_states is not Metric.sync_states:
            raise ValueError(
                f"{type(self).__name__} overrides sync_states with its own cross-shard "
                "aggregation; state_sharding only applies to the standard coalesced sync"
            )
        self._state_shardings[name] = spec

    def set_state_sharding(self, name: str, sharding: Optional[Union[str, ShardSpec]]) -> None:
        """Install (or clear, with ``None``/``"replicated"``) a leaf's sharding spec on a constructed metric."""
        if name not in self._reductions:
            raise KeyError(f"{name!r} is not a registered state leaf of {type(self).__name__}")
        spec = canonical_sharding(sharding)
        if spec is None:
            self._state_shardings.pop(name, None)
            return
        self._install_sharding(name, spec)

    @property
    def state_shardings(self) -> Dict[str, ShardSpec]:
        """A copy of the per-leaf sharding specs."""
        return dict(self._state_shardings)

    # -------------------------------------------------------- functional core
    def init_state(self) -> State:
        """Fresh state: copies of the defaults and a zero update counter."""
        st = {k: (v if isinstance(v, tuple) else v.clone()) for k, v in self._defaults.items()}
        st[_N] = self._zero_count()
        return st

    def update_state(self, state: State, *args: Any, **kwargs: Any) -> State:
        """A new state dict with this batch folded in.

        The input state's tensors are left as they are, except the leaves
        named in ``_inplace_leaves`` (the ``confmat`` leaf of
        ``MulticlassConfusionMatrix`` and its subclasses), which one kernel
        launch adds into in place (as the reference torchmetrics does): clone
        such a state first to keep it. ``compute``, ``forward``,
        ``state_dict`` and the sync hand out copies of those leaves.
        """
        new = dict(self._update(state, *args, **kwargs))
        new[_N] = state[_N] + 1
        return new

    def compute_state(self, state: State) -> Any:
        """Pure compute on a state.

        Sharded leaves that hold this rank's block of a sync are gathered
        first and their padding sliced off (:meth:`_unpad_sharded`): then
        this is a collective every rank must call. A result that shares
        memory with a leaf the update writes in place is a copy, so a later
        update does not change it.
        """
        value = self._compute(self._unpad_sharded(state))
        if not self._inplace_leaves:
            return value
        live = {state[name].untyped_storage().data_ptr() for name in self._inplace_leaves if name in state}
        return _copy_shared(value, live)

    def _unpad_sharded(self, state: State) -> State:
        """``state`` with each sharded leaf as the logical leaf: a rank's block of a sync (shard dimension
        ``ceil(d / world)``) gathered in rank order, the padding of a padded leaf sliced off. The same object
        when nothing is sharded."""
        shardings = self.__dict__.get("_state_shardings") or {}
        if not shardings:
            return state
        out = dict(state)
        n = world_size()
        for name, spec in shardings.items():
            leaf = out.get(name)
            if leaf is None or isinstance(leaf, tuple):
                continue
            d, got = self._defaults[name].shape[spec.axis], leaf.shape[spec.axis]
            if got == d:
                continue
            if n > 1 and got == -(-d // n):
                leaf = torch.cat(list(all_gather_rows(leaf.contiguous())), dim=spec.axis)
            elif got < d:
                raise ValueError(
                    f"sharded leaf {name!r} has {got} entries on axis {spec.axis}: neither the leaf ({d}) nor "
                    f"a block of it in this world of {n}"
                )
            out[name] = leaf.narrow(spec.axis, 0, d)
        return out

    def _align_sharded(self, name: str, a_leaf: Any, b_leaf: Any) -> Tuple[Any, Any]:
        """Zero-pad the shorter of two sharded-leaf operands on the shard axis (a padded copy and a logical
        one merge exactly: zeros are the SUM identity)."""
        spec = self._state_shardings.get(name)
        if spec is None or isinstance(a_leaf, tuple):
            return a_leaf, b_leaf
        da, db = a_leaf.shape[spec.axis], b_leaf.shape[spec.axis]
        if da == db:
            return a_leaf, b_leaf

        def pad(leaf: Tensor, to: int) -> Tensor:
            widths = [0, 0] * (leaf.ndim - spec.axis - 1) + [0, to - leaf.shape[spec.axis]]
            return torch.nn.functional.pad(leaf, widths)

        to = max(da, db)
        return (pad(a_leaf, to) if da < to else a_leaf), (pad(b_leaf, to) if db < to else b_leaf)

    def merge_states(self, a: State, b: State) -> State:
        """Combine two states under the per-leaf reduction table (pure)."""
        out: State = {}
        shardings = self.__dict__.get("_state_shardings") or {}
        for name, reduce in self._reductions.items():
            a_leaf, b_leaf = a[name], b[name]
            if name in shardings:
                a_leaf, b_leaf = self._align_sharded(name, a_leaf, b_leaf)
            out[name] = merge_leaf(reduce, a_leaf, b_leaf, n_a=a[_N], n_b=b[_N])
        out[_N] = a[_N] + b[_N]
        return out

    def sync_states(self, state: State, compression: Optional[Any] = None, weight: Optional[Any] = None) -> State:
        """Cross-rank sync over the default process group (pure).

        One ``all_reduce`` per (dtype, op) bucket of the reduction table
        (:func:`torchmetrics_tpu_torch.parallel.coalesce.coalesced_sync_state`);
        the ``_n`` counter rides the int32 sum bucket, so after one update on
        every rank it equals the world size. A synced CAT list state is one
        tensor of every rank's rows in rank order (the reference's order; the
        JAX package interleaves the devices per update).

        ``compression`` (a
        :class:`~torchmetrics_tpu_torch.parallel.compress.CompressionConfig`)
        quantizes the large float32 sum buckets; ``weight`` (this rank's 0/1
        scalar) masks this rank out of the sync. Sharded leaves come back as
        this rank's block.
        """
        from torchmetrics_tpu_torch.parallel.coalesce import coalesced_sync_state

        sub: State = {name: state[name] for name in self._reductions}
        sub[_N] = state[_N]
        return coalesced_sync_state(sub, self._reductions, compression=compression, weight=weight,
                                    shardings=self.__dict__.get("_state_shardings") or None)

    def sync_out_specs(self) -> Dict[str, Optional[ShardSpec]]:
        """``{leaf: ShardSpec or None}`` of a synced state: a sharded leaf holds this rank's block on its
        spec's axis, every other leaf (``_n`` too) is replicated (``None``). The port has no
        ``PartitionSpec``, so this stands for JAX's ``shard_map`` out_specs."""
        specs: Dict[str, Optional[ShardSpec]] = {name: self._state_shardings.get(name) for name in self._reductions}
        specs[_N] = None
        return specs

    def host_sync_states(self, state: State) -> State:
        """:meth:`sync_states`: ``torch.distributed`` is already cross-process."""
        return self.sync_states(state)

    # ------------------------------------------------------- subclass contract
    def _update(self, state: State, *args: Any, **kwargs: Any) -> State:
        raise NotImplementedError

    def _compute(self, state: State) -> Any:
        raise NotImplementedError

    def _tensor(self, x: Any) -> Tensor:
        """An input as a tensor on this metric's device (64-bit types narrowed)."""
        return to_tensor(x, self.device)

    # ----------------------------------------------------------------- facade
    @property
    def update_called(self) -> bool:
        return int(self._state[_N]) > 0

    @property
    def update_count(self) -> int:
        return int(self._state[_N])

    @property
    def metric_state(self) -> State:
        """The current raw state (including the ``_n`` counter)."""
        return self._state

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Accumulate a batch into the global state."""
        self._computed = None
        self._state = self.update_state(self._state, *args, **kwargs)

    def compute(self) -> Any:
        """Compute over the accumulated state."""
        if not self.update_called:
            rank_zero_warn(
                f"The ``compute`` method of metric {self.__class__.__name__} was called before "
                "the ``update`` method which may lead to errors, as metric states have not yet been updated.",
                UserWarning,
            )
        if self.compute_with_cache and self._computed is not None:
            return self._computed
        value = self.compute_state(self._state)
        if self.compute_with_cache:
            self._computed = value
        return value

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Batch value and global accumulation in one call.

        The batch state is computed fresh, merged into the global state, and
        ``compute`` of the batch state is returned. Metrics whose update does
        not distribute over merge set ``full_state_update=True`` and update
        twice instead.
        """
        if self.full_state_update:
            self._state = self.update_state(self._state, *args, **kwargs)
            batch_state = self.update_state(self.init_state(), *args, **kwargs)
        else:
            batch_state = self.update_state(self.init_state(), *args, **kwargs)
            self._state = self.merge_states(self._state, batch_state)
        self._computed = None
        self._forward_cache = self.compute_state(batch_state)
        return self._forward_cache

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """The kwargs that this metric's ``_update`` accepts, so that a
        ``MetricCollection`` can pass one kwargs dict to different metrics."""
        params = inspect.signature(self._update).parameters
        if any(p.kind == p.VAR_KEYWORD for p in params.values()):
            return kwargs
        names = {n for n, p in params.items() if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
        return {k: v for k, v in kwargs.items() if k in names and k != "state"}

    def reset(self) -> None:
        """Restore the default state."""
        self._state = self.init_state()
        self._computed = None
        self._forward_cache = None

    def set_approx(self, approx: Optional[str], approx_error: Optional[float] = None) -> None:
        """Switch a constructed metric between its exact and approximate state layouts.

        Only metrics that define ``_install_approx_states`` (which registers
        their leaves under the current ``approx`` config) support the switch;
        any other raises ``ValueError``. The accumulated state is dropped: the
        old layout's leaves cannot be read under the new one.
        """
        approx, approx_error = _validate_approx(approx, approx_error)
        rebuild = getattr(self, "_install_approx_states", None)
        if rebuild is None:
            raise ValueError(
                f"{type(self).__name__} does not support runtime approx switching: "
                "it defines no _install_approx_states re-registration hook. "
                "Construct a fresh instance with approx=... instead."
            )
        self.approx, self.approx_error = approx, approx_error
        for name in list(self._reductions):
            del self._reductions[name]
            self._defaults.pop(name, None)
            self._persistent.pop(name, None)
            self._value_ranges.pop(name, None)
            self._state_shardings.pop(name, None)
            self._state.pop(name, None)
        rebuild()
        self.reset()

    # ------------------------------------------------------------- lifecycle
    def clone(self) -> "Metric":
        return deepcopy(self)

    def persistent(self, mode: bool = False) -> None:
        for name in self._persistent:
            self._persistent[name] = mode

    def state_dict(self, destination: Optional[Dict] = None, prefix: str = "") -> Dict[str, Any]:
        """Persistent state leaves: tensors, and lists of tensors for list states."""
        destination = destination if destination is not None else {}
        for name, persistent in self._persistent.items():
            if persistent:
                value = self._state[name]
                if name in self._inplace_leaves:  # the next update would change it
                    value = value.clone()
                destination[prefix + name] = list(value) if isinstance(value, tuple) else value
        return destination

    def _validate_leaf(self, name: str, value: Any) -> Any:
        """One state leaf checked against the metric's spec and placed on its
        device. Raises :class:`StateRestoreError` naming the leaf on a kind,
        dtype or shape mismatch."""
        if name not in self._defaults:
            raise StateRestoreError(
                f"Leaf {name!r} is not a registered state of {type(self).__name__} "
                f"(known: {sorted(self._defaults)}).",
                leaf=name,
                reason="unknown-leaf",
            )
        default = self._defaults[name]
        if isinstance(default, tuple):
            if not isinstance(value, (list, tuple)):
                raise StateRestoreError(
                    f"List-state leaf {name!r} of {type(self).__name__} expects a sequence of tensors; "
                    f"got {type(value).__name__}.",
                    leaf=name,
                    reason="kind",
                )
            return tuple(torch.as_tensor(v, device=self.device) for v in value)
        if isinstance(value, (list, tuple)):
            raise StateRestoreError(
                f"Tensor-state leaf {name!r} of {type(self).__name__} expects a tensor; got a sequence.",
                leaf=name,
                reason="kind",
            )
        arr = torch.as_tensor(value, device=self.device)
        if arr.dtype != default.dtype:
            raise StateRestoreError(
                f"State leaf {name!r} of {type(self).__name__} has dtype {arr.dtype}, expected {default.dtype}.",
                leaf=name,
                reason="dtype",
            )
        if arr.shape != default.shape:
            raise StateRestoreError(
                f"State leaf {name!r} of {type(self).__name__} has shape {tuple(arr.shape)}, "
                f"expected {tuple(default.shape)}.",
                leaf=name,
                reason="shape",
            )
        return arr

    def load_state_dict(self, state_dict: Mapping[str, Any], prefix: str = "") -> None:
        """Install persisted leaves, all or nothing.

        Unknown keys under ``prefix`` and expected persistent keys that are
        missing are reported with ``rank_zero_warn``; a leaf that fails
        validation raises :class:`StateRestoreError` before any state is
        touched.
        """
        known = {prefix + name for name in self._defaults}
        unknown = sorted(k for k in state_dict if k.startswith(prefix) and k not in known)
        if unknown:
            rank_zero_warn(
                f"Ignoring {len(unknown)} unknown key(s) in state_dict for metric "
                f"{type(self).__name__}: {unknown} (not registered states of this metric).",
                UserWarning,
            )
        expected = {prefix + name for name, persistent in self._persistent.items() if persistent}
        missing = sorted(expected - set(state_dict))
        if missing:
            rank_zero_warn(
                f"Metric {type(self).__name__} expected persistent state key(s) {missing} "
                "in state_dict but they are missing; those states keep their current values.",
                UserWarning,
            )
        staged = {
            name: self._validate_leaf(name, state_dict[prefix + name])
            for name in self._defaults
            if prefix + name in state_dict
        }
        for name in self._inplace_leaves:  # the updates must not write into the caller's tensor
            if name in staged:
                staged[name] = staged[name].clone()
        self._state.update(staged)
        self._computed = None

    # pickling: tensors travel on the CPU, so a pickle loads on any machine
    # that has the metric's device
    def __getstate__(self) -> Dict[str, Any]:
        d = self.__dict__.copy()
        cpu = torch.device("cpu")
        d["_state"] = {k: _move(v, cpu) for k, v in self._state.items()}
        d["_defaults"] = {k: _move(v, cpu) for k, v in self._defaults.items()}
        for name in self._device_attrs:
            if d.get(name) is not None:
                d[name] = d[name].to(cpu)
        d["_computed"] = None
        d["_forward_cache"] = None
        d.pop("_cadence_stepper", None)  # a sharded_update(sync_policy=...) carry belongs to this object only
        return d

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self.__dict__.setdefault("_state_shardings", {})
        self._place(self.device)

    def _place(self, device: torch.device) -> None:
        self._state = {k: _move(v, device) for k, v in self._state.items()}
        self._defaults = {k: _move(v, device) for k, v in self._defaults.items()}
        for name in self._device_attrs:
            if getattr(self, name, None) is not None:
                setattr(self, name, getattr(self, name).to(device))

    def to(self, device: Union[str, torch.device]) -> "Metric":
        """Move the state (and the metric's other tensors) to ``device``."""
        self.device = resolve_device(device)
        self._place(self.device)
        self._computed = None
        self._forward_cache = None
        return self

    @property
    def dtype(self) -> torch.dtype:
        """The float type of the state: float32 unless :meth:`set_dtype` changed it."""
        return self.__dict__.get("_dtype") or torch.float32

    def set_dtype(self, dst_type: Any) -> "Metric":
        """Cast the float state leaves and their defaults to ``dst_type`` (a torch dtype, or a name or numpy
        dtype such as ``"float16"``); integer leaves and the ``_n`` counter stay."""
        dst = dst_type if isinstance(dst_type, torch.dtype) else getattr(torch, str(np.dtype(dst_type)), None)
        if not isinstance(dst, torch.dtype):
            raise TypeError(f"set_dtype takes a torch dtype or the name of one, got {dst_type!r}")
        self._dtype = dst

        def cast(x: Any) -> Any:
            if isinstance(x, tuple):
                return tuple(cast(xi) for xi in x)
            return x.to(dst) if isinstance(x, Tensor) and x.is_floating_point() else x

        self._state = {k: cast(v) for k, v in self._state.items()}
        self._defaults = {k: cast(v) for k, v in self._defaults.items()}
        self._computed = None
        self._forward_cache = None
        return self

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}()"

    def __hash__(self) -> int:
        # identity plus state names, as in the JAX package: ``__eq__`` below
        # builds a composition, and without this Python would make metrics
        # unhashable (no sets, no dict keys)
        return hash((id(self), tuple(self._defaults.keys())))

    # ------------------------------------------------------------- arithmetic
    # Each operator builds a lazy ``CompositionalMetric``; ``__eq__`` and
    # ``__ne__`` too, so compare metrics by identity (``is``), never ``==``.
    def _compose(self, op: Callable, other: Any, reverse: bool = False) -> "Metric":
        from torchmetrics_tpu_torch.core.composition import CompositionalMetric

        return CompositionalMetric(op, other, self) if reverse else CompositionalMetric(op, self, other)

    def __add__(self, other: Any) -> "Metric":
        return self._compose(torch.add, other)

    def __radd__(self, other: Any) -> "Metric":
        return self._compose(torch.add, other, reverse=True)

    def __sub__(self, other: Any) -> "Metric":
        return self._compose(torch.sub, other)

    def __rsub__(self, other: Any) -> "Metric":
        return self._compose(torch.sub, other, reverse=True)

    def __mul__(self, other: Any) -> "Metric":
        return self._compose(torch.mul, other)

    def __rmul__(self, other: Any) -> "Metric":
        return self._compose(torch.mul, other, reverse=True)

    def __truediv__(self, other: Any) -> "Metric":
        return self._compose(torch.true_divide, other)

    def __rtruediv__(self, other: Any) -> "Metric":
        return self._compose(torch.true_divide, other, reverse=True)

    def __floordiv__(self, other: Any) -> "Metric":
        return self._compose(torch.floor_divide, other)

    def __rfloordiv__(self, other: Any) -> "Metric":
        return self._compose(torch.floor_divide, other, reverse=True)

    def __mod__(self, other: Any) -> "Metric":
        return self._compose(torch.remainder, other)

    def __rmod__(self, other: Any) -> "Metric":
        return self._compose(torch.remainder, other, reverse=True)

    def __pow__(self, other: Any) -> "Metric":
        return self._compose(torch.pow, other)

    def __rpow__(self, other: Any) -> "Metric":
        return self._compose(torch.pow, other, reverse=True)

    def __matmul__(self, other: Any) -> "Metric":
        return self._compose(torch.matmul, other)

    def __rmatmul__(self, other: Any) -> "Metric":
        return self._compose(torch.matmul, other, reverse=True)

    def __and__(self, other: Any) -> "Metric":
        return self._compose(torch.bitwise_and, other)

    def __rand__(self, other: Any) -> "Metric":
        return self._compose(torch.bitwise_and, other, reverse=True)

    def __or__(self, other: Any) -> "Metric":
        return self._compose(torch.bitwise_or, other)

    def __ror__(self, other: Any) -> "Metric":
        return self._compose(torch.bitwise_or, other, reverse=True)

    def __xor__(self, other: Any) -> "Metric":
        return self._compose(torch.bitwise_xor, other)

    def __rxor__(self, other: Any) -> "Metric":
        return self._compose(torch.bitwise_xor, other, reverse=True)

    def __eq__(self, other: Any) -> "Metric":  # type: ignore[override]
        return self._compose(torch.eq, other)

    def __ne__(self, other: Any) -> "Metric":  # type: ignore[override]
        return self._compose(torch.ne, other)

    def __lt__(self, other: Any) -> "Metric":
        return self._compose(torch.lt, other)

    def __le__(self, other: Any) -> "Metric":
        return self._compose(torch.le, other)

    def __gt__(self, other: Any) -> "Metric":
        return self._compose(torch.gt, other)

    def __ge__(self, other: Any) -> "Metric":
        return self._compose(torch.ge, other)

    def __neg__(self) -> "Metric":
        return self._compose(torch.neg, None)

    def __pos__(self) -> "Metric":
        # ``abs``, as in the JAX package
        return self._compose(torch.abs, None)

    def __abs__(self) -> "Metric":
        return self._compose(torch.abs, None)

    def __invert__(self) -> "Metric":
        return self._compose(torch.logical_not, None)

    def __getitem__(self, idx: Any) -> "Metric":
        return self._compose(lambda x: x[idx], None)
