"""``MetricCollection`` with compute groups (counterpart of ``torchmetrics_tpu/collections.py``).

Metrics whose states are equal after the first update form a compute group:
from then on only the group's leader runs ``update`` and the members share
its state. Sharing is plain reference assignment: the members read the
leader's state dict, so a leaf the leader's update writes into in place (the
multiclass confusion matrix) is the members' too.

The functional API threads ``{leader name: state}`` dicts through
``init_states -> update_states -> sync_states -> compute_states``;
``sync_states`` syncs every leader in ONE coalesced plan (one ``all_reduce``
per (dtype, op) bucket over the whole collection).

``sync_policy`` (a :class:`~torchmetrics_tpu_torch.parallel.coalesce.SyncPolicy`)
is the default cadence of ``parallel.sharded_collection_update`` on the
collection. The JAX collection's fused single-graph update (``jit=True``)
needs the compile slice and its telemetry the observability slice, neither
ported yet.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassF1Score
    >>> from torchmetrics_tpu_torch.collections import MetricCollection
    >>> metrics = MetricCollection({"acc": MulticlassAccuracy(num_classes=3, average="micro", device="cpu"),
    ...                             "f1": MulticlassF1Score(num_classes=3, average="macro", device="cpu")})
    >>> metrics.update(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 2, 2]))
    >>> {k: round(float(v), 4) for k, v in sorted(metrics.compute().items())}
    {'acc': 0.75, 'f1': 0.7778}
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.core.metric import Metric


def _flatten_dict(x: Dict) -> Tuple[Dict, bool]:
    """Flatten a dict of dicts into one dict; returns ``(flat, all_unique)``."""
    new_dict = {}
    duplicates = False
    for key, value in x.items():
        items = value.items() if isinstance(value, dict) else [(key, value)]
        for k, v in items:
            duplicates |= k in new_dict
            new_dict[k] = v
    return new_dict, not duplicates


def _allclose(a: torch.Tensor, b: torch.Tensor, atol: float = 1e-8) -> bool:
    """``jnp.allclose`` in float32, as the JAX package compares states."""
    return a.shape == b.shape and bool(torch.allclose(a.to(torch.float32), b.to(torch.float32), atol=atol))


class MetricCollection(dict):
    """Dict-like container of metrics that share one ``update``/``compute`` call."""

    _groups: Dict[int, List[str]]

    def __init__(
        self,
        metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
        jit: bool = False,
        sync_policy: Optional[Any] = None,
    ) -> None:
        super().__init__()
        if jit:
            raise NotImplementedError(
                "MetricCollection(jit=True) is not ported yet: it needs the compile slice (ROADMAP Queue 1 item 11)"
            )
        if sync_policy is not None:
            from torchmetrics_tpu_torch.parallel.coalesce import SyncPolicy

            if not isinstance(sync_policy, SyncPolicy):
                raise ValueError(f"Expected `sync_policy` to be a parallel.SyncPolicy, got {type(sync_policy)}")
        # default cadence for sharded_collection_update(...) on this collection
        self._sync_policy = sync_policy
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        self._groups_checked = False
        self._groups = {}
        self.add_metrics(metrics, *additional_metrics)

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")

    # ------------------------------------------------------------- population
    def add_metrics(
        self, metrics: Union[Metric, Sequence[Metric], Dict[str, Metric]], *additional_metrics: Metric
    ) -> None:
        if isinstance(metrics, Metric):
            metrics = [metrics]
        if isinstance(metrics, Sequence):
            metrics = list(metrics)
            remain: list = []
            for m in additional_metrics:
                (metrics if isinstance(m, Metric) else remain).append(m)
            if remain:
                raise ValueError(
                    f"You have passes extra arguments {remain} which are not `Metric` so they will be ignored."
                )
        elif additional_metrics:
            raise ValueError(
                f"You have passed extra arguments {additional_metrics} which are not compatible"
                f" with first passed dictionary {metrics} so they will be ignored."
            )

        if isinstance(metrics, dict):
            for name in sorted(metrics.keys()):
                metric = metrics[name]
                if isinstance(metric, Metric):
                    self[name] = metric
                elif isinstance(metric, MetricCollection):
                    for k, v in metric.items(keep_base=False):
                        self[f"{name}_{k}"] = v
                else:
                    raise ValueError(
                        f"Value {metric} belonging to key {name} is not an instance of"
                        " `torchmetrics_tpu_torch.Metric` or `torchmetrics_tpu_torch.MetricCollection`"
                    )
        elif isinstance(metrics, Sequence):
            for metric in metrics:
                if isinstance(metric, Metric):
                    name = metric.__class__.__name__
                    if name in self:
                        raise ValueError(f"Encountered two metrics both named {name}")
                    self[name] = metric
                elif isinstance(metric, MetricCollection):
                    for k, v in metric.items(keep_base=False):
                        self[k] = v
                else:
                    raise ValueError(
                        f"Input {metric} to `MetricCollection` is not a instance of"
                        " `torchmetrics_tpu_torch.Metric` or `torchmetrics_tpu_torch.MetricCollection`"
                    )
        else:
            raise ValueError(
                "Unknown input to MetricCollection. Expected, `Metric`, `MetricCollection` or `dict`/`sequence` of the"
                f" previous, but got {metrics}"
            )
        self._groups_checked = False

    # ------------------------------------------------------------ group logic
    @staticmethod
    def _equal_metric_states(metric1: Metric, metric2: Metric) -> bool:
        """True if the two metrics hold the same state leaves with equal values."""
        if len(metric1._defaults) == 0 or len(metric2._defaults) == 0:
            return False
        if metric1._defaults.keys() != metric2._defaults.keys():
            return False
        for key in metric1._defaults:
            s1, s2 = metric1._state[key], metric2._state[key]
            if isinstance(s1, tuple) and isinstance(s2, tuple):
                if len(s1) != len(s2) or not all(_allclose(a, b) for a, b in zip(s1, s2)):
                    return False
            elif isinstance(s1, tuple) or isinstance(s2, tuple) or not _allclose(s1, s2):
                return False
        return True

    def _merge_compute_groups(self) -> None:
        """Merge groups whose leaders hold equal states, until none merge."""
        merged = True
        while merged:
            merged = False
            for i1, members1 in list(self._groups.items()):
                for i2, members2 in list(self._groups.items()):
                    if i1 != i2 and self._equal_metric_states(self[members1[0]], self[members2[0]]):
                        self._groups[i1].extend(self._groups.pop(i2))
                        merged = True
                        break
                if merged:
                    break
        self._groups = dict(enumerate(self._groups.values()))

    def _init_groups(self) -> None:
        if isinstance(self._enable_compute_groups, list):
            self._groups = dict(enumerate(self._enable_compute_groups))
            self._groups_checked = True
        else:
            self._groups = {i: [name] for i, name in enumerate(self.keys(keep_base=True))}
            self._groups_checked = not self._enable_compute_groups

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        return self._groups

    # ------------------------------------------------------------- lifecycle
    def update(self, *args: Any, **kwargs: Any) -> None:
        if not self._groups:
            self._init_groups()
        if self._groups_checked:
            # steady state: leaders update, members share the leader's state
            for members in self._groups.values():
                leader = self[members[0]]
                leader.update(*args, **leader._filter_kwargs(**kwargs))
                self._alias(members)
        else:
            for m in self.values():
                m.update(*args, **m._filter_kwargs(**kwargs))
            if self._enable_compute_groups and not isinstance(self._enable_compute_groups, list):
                self._merge_compute_groups()
            self._groups_checked = True

    def _alias(self, members: List[str]) -> None:
        leader_state = self[members[0]]._state
        for name in members[1:]:
            self[name]._state = leader_state
            self[name]._computed = None

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        res = {k: m(*args, **m._filter_kwargs(**kwargs)) for k, m in self.items(keep_base=True)}
        # members get the same inputs, so equal states stay equal: a first
        # forward counts as the group-forming update
        if not self._groups:
            self._init_groups()
        if not self._groups_checked:
            if self._enable_compute_groups and not isinstance(self._enable_compute_groups, list):
                self._merge_compute_groups()
            self._groups_checked = True
        return self._to_renamed_dict(res)

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.forward(*args, **kwargs)

    def compute(self) -> Dict[str, Any]:
        return self._to_renamed_dict({k: m.compute() for k, m in self.items(keep_base=True)})

    def reset(self) -> None:
        for m in self.values():
            m.reset()

    def _to_renamed_dict(self, res: Dict[str, Any]) -> Dict[str, Any]:
        res, _ = _flatten_dict(res)
        return {self._set_name(k): v for k, v in res.items()}

    # ---------------------------------------------------- functional state API
    # States live in a {leader name: state} dict. The groups are those known
    # when it is built: configured ones, or one per metric before a first
    # eager update has merged any.
    def _functional_groups(self) -> Dict[int, List[str]]:
        if not self._groups:
            self._init_groups()
        return self._groups

    def init_states(self) -> Dict[str, Any]:
        """Fresh states, keyed by group-leader name."""
        return {members[0]: self[members[0]].init_state() for members in self._functional_groups().values()}

    def update_states(self, states: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Pure update of every group leader's state."""
        return {
            name: self[name].update_state(st, *args, **self[name]._filter_kwargs(**kwargs))
            for name, st in states.items()
        }

    def merge_states(self, a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
        return {k: self[k].merge_states(a[k], b[k]) for k in a}

    def sync_states(self, states: Dict[str, Any]) -> Dict[str, Any]:
        """Cross-rank sync of every leader state in ONE coalesced plan."""
        from torchmetrics_tpu_torch.parallel.coalesce import coalesced_metric_sync

        names = list(states)
        synced = coalesced_metric_sync([self[k] for k in names], [states[k] for k in names])
        return dict(zip(names, synced))

    def compute_states(self, states: Dict[str, Any]) -> Dict[str, Any]:
        """Results for every metric; members compute from their leader's state."""
        res = {}
        for members in self._functional_groups().values():
            for name in members:
                res[name] = self[name].compute_state(states[members[0]])
        return self._to_renamed_dict(res)

    def _realias_groups(self) -> None:
        """After a per-metric restore, point every member back at its leader's state."""
        if self._groups_checked:
            for members in self._groups.values():
                self._alias(members)

    # -------------------------------------------------------------- dict api
    def keys(self, keep_base: bool = False):  # type: ignore[override]
        if keep_base:
            return super().keys()
        return [self._set_name(k) for k in super().keys()]

    def items(self, keep_base: bool = False):  # type: ignore[override]
        if keep_base:
            return super().items()
        return [(self._set_name(k), v) for k, v in super().items()]

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(f"'{self.__class__.__name__}' object has no attribute '{name}'") from None

    def __iter__(self):
        return iter(self.keys(keep_base=True))

    # ------------------------------------------------------------------ misc
    def __reduce__(self):
        # copies and pickles keep the base names: the default protocol would
        # take the renamed ones from ``items()``, and a clone of a prefixed
        # collection would carry the old prefix in its keys (as the JAX
        # package's clone does)
        state = {k: v for k, v in self.__dict__.items() if k != "_cadence_stepper"}  # belongs to this object
        return self.__class__.__new__, (self.__class__,), state, None, iter(dict.items(self))

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def persistent(self, mode: bool = True) -> None:
        for m in self.values():
            m.persistent(mode)

    def state_dict(self) -> Dict[str, Any]:
        return {k: m.state_dict() for k, m in self.items(keep_base=True)}

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        for k, m in self.items(keep_base=True):
            if k in state_dict:
                m.load_state_dict(state_dict[k])
        self._realias_groups()

    def __repr__(self) -> str:
        repr_str = self.__class__.__name__ + "("
        if self.prefix:
            repr_str += f"\n  prefix={self.prefix}"
        if self.postfix:
            repr_str += f"\n  postfix={self.postfix}"
        for k, v in self.items(keep_base=True):
            repr_str += f"\n  ({k}): {v!r}"
        return repr_str + "\n)"
