"""What a reader gets from a metric stays as it was when a later update runs.

The multiclass confusion-matrix family adds each batch into its ``confmat``
leaf in place (one kernel launch on the card). ``compute``, ``state_dict``,
``forward``'s batch value, ``clone``, a ``MetricCollection``'s compute
groups and the sync must still hand out values that a later ``update`` does
not change, as the JAX package's immutable arrays are. Values are compared
exactly (``torch.equal``): a reader's copy is the value itself.
"""

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu_torch.collections import MetricCollection

C, L, N = 4, 3, 32
WRAPPERS = ("ConfusionMatrix", "CohenKappa", "MatthewsCorrCoef", "JaccardIndex")
TASKS = ("binary", "multiclass", "multilabel")
CASES = [(w, t) for w in WRAPPERS for t in TASKS if not (w == "CohenKappa" and t == "multilabel")]


def _batch(task, seed):
    rng = np.random.default_rng(seed)
    if task == "binary":
        return torch.from_numpy(rng.uniform(size=N).astype(np.float32)), torch.from_numpy(rng.integers(0, 2, N))
    if task == "multiclass":
        return torch.from_numpy(rng.integers(0, C, N)), torch.from_numpy(rng.integers(0, C, N))
    return (torch.from_numpy(rng.uniform(size=(N, L)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 2, (N, L))))


def _make(wrapper, task):
    size = {"binary": {}, "multiclass": {"num_classes": C}, "multilabel": {"num_labels": L}}[task]
    metric = getattr(tc, wrapper)(task=task, device="cpu", **size)
    metric.persistent(True)
    return metric


def _frozen(value):
    if isinstance(value, dict):
        return {k: _frozen(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_frozen(v) for v in value]
    return value.clone()


def _assert_same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("grouped", [False, True], ids=["alone", "grouped"])
@pytest.mark.parametrize(("wrapper", "task"), CASES)
def test_compute_and_state_dict_survive_a_later_update(wrapper, task, grouped):
    if grouped:
        holder = MetricCollection({"a": _make(wrapper, task), "b": _make(wrapper, task)})
        holder.update(*_batch(task, 0))
        assert list(holder.compute_groups.values()) == [["a", "b"]]
    else:
        holder = _make(wrapper, task)
        holder.update(*_batch(task, 0))
    value, state = holder.compute(), holder.state_dict()
    value_then, state_then = _frozen(value), _frozen(state)
    holder.update(*_batch(task, 1))
    _assert_same(value, value_then)
    _assert_same(state, state_then)
    # the update did count: the state moved on
    members = [holder["a"], holder["b"]] if grouped else [holder]
    for m in members:
        assert not torch.equal(m.metric_state["confmat"], state_then["confmat"] if not grouped else
                               state_then["a"]["confmat"])


def test_forward_clone_and_sync_of_the_in_place_leaf():
    metric = _make("ConfusionMatrix", "multiclass")
    batch_value = metric(*_batch("multiclass", 0))
    batch_then = batch_value.clone()
    twin = metric.clone()
    twin_then = twin.compute().clone()
    synced = metric.sync_states(metric.metric_state)
    synced_then = synced["confmat"].clone()
    metric.update(*_batch("multiclass", 1))
    assert torch.equal(batch_value, batch_then)
    assert torch.equal(twin.compute(), twin_then)
    assert torch.equal(synced["confmat"], synced_then)
    assert not torch.equal(metric.compute(), twin_then)


def test_loaded_state_dict_is_not_written_by_updates():
    source = _make("ConfusionMatrix", "multiclass")
    source.update(*_batch("multiclass", 0))
    sd = source.state_dict()
    sd_then = _frozen(sd)
    target = _make("ConfusionMatrix", "multiclass")
    target.load_state_dict(sd)
    target.update(*_batch("multiclass", 1))
    _assert_same(sd, sd_then)

