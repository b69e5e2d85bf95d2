"""The port's ``MetricCollection``, held against the JAX package's.

Compute groups, values, renaming, cloning and state dicts run in this
process; the functional ``sync_states`` (every group leader in one
coalesced plan) runs in one gloo world of 4 CPU ranks
(``tests/helpers/torch_dist.py``) against the JAX collection's
``sync_states`` under ``shard_map`` over 4 virtual devices.

Tolerances: integer states exact; accuracy and F1 ``rtol=1e-6``; AUROC and
AP ``rtol=1e-5, atol=1e-6`` (float32 sums in another order than XLA's).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.classification as tc
from tests.helpers.torch_dist import run_world, worker_main
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.convert import collection_states_from_jax
from torchmetrics_tpu_torch.core.reductions import COLLECTIVES

WORLD = 4
C = 6
ROWS = 16


def _bundle(pkg, **device):
    """Metrics of which some share a state: both accuracies and F1 hold the
    same per-class tp/fp/tn/fn; AUROC, AP and the PR curve at 20 thresholds
    share confmat; the exact AP stands alone."""
    return {
        "acc_macro": pkg.MulticlassAccuracy(num_classes=C, average="macro", validate_args=False, **device),
        "acc_micro": pkg.MulticlassAccuracy(num_classes=C, average="micro", validate_args=False, **device),
        "f1": pkg.MulticlassF1Score(num_classes=C, average="macro", validate_args=False, **device),
        "auroc": pkg.MulticlassAUROC(num_classes=C, thresholds=20, validate_args=False, **device),
        "ap20": pkg.MulticlassAveragePrecision(num_classes=C, thresholds=20, validate_args=False, **device),
        "prc": pkg.MulticlassPrecisionRecallCurve(num_classes=C, thresholds=20, validate_args=False, **device),
        "ap": pkg.MulticlassAveragePrecision(num_classes=C, thresholds=None, validate_args=False, **device),
    }


def _sync_bundle(pkg, **device):
    """The multi-device step's collection: no two members share a state."""
    return {
        "acc": pkg.MulticlassAccuracy(num_classes=C, average="micro", validate_args=False, **device),
        "f1": pkg.MulticlassF1Score(num_classes=C, average="macro", validate_args=False, **device),
        "auroc": pkg.MulticlassAUROC(num_classes=C, thresholds=20, validate_args=False, **device),
        "ap": pkg.MulticlassAveragePrecision(num_classes=C, thresholds=None, validate_args=False, **device),
    }


def _batch(seed, rows=ROWS):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(rows, C)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return probs.astype(np.float32), rng.integers(0, C, rows).astype(np.int32)


def _collections(**kwargs):
    import jax.numpy as jnp

    import torchmetrics_tpu.classification as jc
    from torchmetrics_tpu import MetricCollection as JaxCollection

    jm = JaxCollection(_bundle(jc), **kwargs)
    tm = MetricCollection(_bundle(tc, device="cpu"), **kwargs)
    return jm, tm, jnp


def _assert_results(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (list, tuple)):
            for gi, wi in zip(g, w):
                _assert_results({"x": gi}, {"x": wi})
            continue
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=k)


def test_compute_groups_equal_jax():
    jm, tm, jnp = _collections()
    p, t = _batch(0)
    jm.update(jnp.asarray(p), jnp.asarray(t))
    tm.update(torch.from_numpy(p), torch.from_numpy(t))
    assert tm.compute_groups == jm.compute_groups
    groups = sorted(sorted(g) for g in tm.compute_groups.values())
    assert groups == [["acc_macro", "acc_micro", "f1"], ["ap"], ["ap20", "auroc", "prc"]]


@pytest.mark.parametrize("compute_groups", [True, False, [["acc_macro", "f1"], ["acc_micro"], ["auroc", "ap20", "prc"], ["ap"]]],
                         ids=["auto", "off", "given"])
def test_values_equal_jax_over_several_updates(compute_groups):
    jm, tm, jnp = _collections(compute_groups=compute_groups)
    for seed in range(3):
        p, t = _batch(seed)
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    assert tm.compute_groups == jm.compute_groups
    _assert_results(tm.compute(), jm.compute())
    for members in tm.compute_groups.values():  # members share the leader's state
        assert all(tm[m]._state is tm[members[0]]._state for m in members)


def test_functional_path_equals_jax():
    jm, tm, jnp = _collections(compute_groups=[["acc_macro", "f1"], ["acc_micro"], ["auroc", "ap20", "prc"], ["ap"]])
    js, ts = jm.init_states(), tm.init_states()
    assert list(ts) == list(js) == ["acc_macro", "acc_micro", "auroc", "ap"]
    for seed in range(2):
        p, t = _batch(10 + seed)
        js = jm.update_states(js, jnp.asarray(p), jnp.asarray(t))
        ts = tm.update_states(ts, torch.from_numpy(p), torch.from_numpy(t))
    _assert_results(tm.compute_states(ts), jm.compute_states(js))
    merged = tm.merge_states(ts, ts)
    assert int(merged["auroc"]["_n"]) == 4
    # a JAX collection state carried into the port computes the same values
    np_states = {k: {n: (list(map(np.asarray, v)) if isinstance(v, tuple) else np.asarray(v)) for n, v in st.items()}
                 for k, st in js.items()}
    _assert_results(tm.compute_states(collection_states_from_jax(tm, np_states)), jm.compute_states(js))


def test_prefix_postfix_and_clone():
    tm = MetricCollection(_bundle(tc, device="cpu"), prefix="val_", postfix="_x")
    p, t = _batch(1)
    tm.update(torch.from_numpy(p), torch.from_numpy(t))
    assert sorted(tm.compute()) == sorted(f"val_{k}_x" for k in _bundle(tc, device="cpu"))
    assert tm.keys()[0].startswith("val_") and "acc_macro" in tm.keys(keep_base=True)
    other = tm.clone(prefix="test_")
    assert sorted(other.compute()) == sorted(f"test_{k}_x" for k in _bundle(tc, device="cpu"))
    assert other["auroc"] is not tm["auroc"]
    assert list(other.keys(keep_base=True)) == list(tm.keys(keep_base=True))  # the JAX clone renames these
    _assert_results({k[5:]: v for k, v in other.compute().items()}, {k[4:]: v for k, v in tm.compute().items()})
    with pytest.raises(ValueError):
        MetricCollection(_bundle(tc, device="cpu"), prefix=3)


def test_state_dict_round_trip_realiases_groups():
    tm = MetricCollection(_bundle(tc, device="cpu"))
    tm.persistent(True)
    for seed in range(2):
        p, t = _batch(20 + seed)
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    sd = tm.state_dict()
    assert set(sd) == set(tm.keys(keep_base=True))
    fresh = MetricCollection(_bundle(tc, device="cpu"))
    p, t = _batch(99)
    fresh.update(torch.from_numpy(p), torch.from_numpy(t))  # forms the same groups
    fresh.load_state_dict(sd)
    _assert_results(fresh.compute(), tm.compute())
    for members in fresh.compute_groups.values():
        assert all(fresh[m]._state is fresh[members[0]]._state for m in members)


def test_forward_and_reset():
    jm, tm, jnp = _collections()
    p, t = _batch(5)
    _assert_results(tm(torch.from_numpy(p), torch.from_numpy(t)), jm(jnp.asarray(p), jnp.asarray(t)))
    assert tm.compute_groups == jm.compute_groups
    tm.reset()
    assert all(not m.update_called for m in tm.values())


def test_bad_inputs_raise():
    with pytest.raises(ValueError):
        MetricCollection([tc.MulticlassAccuracy(num_classes=3, device="cpu"), tc.MulticlassAccuracy(num_classes=3, device="cpu")])
    with pytest.raises(ValueError):
        MetricCollection({"a": 3})
    with pytest.raises(NotImplementedError, match="item 11"):
        MetricCollection(tc.MulticlassAccuracy(num_classes=3, device="cpu"), jit=True)
    with pytest.raises(ValueError, match="SyncPolicy"):
        MetricCollection(tc.MulticlassAccuracy(num_classes=3, device="cpu"), sync_policy={"every_n_steps": 2})


# ------------------------------------------------------------ the gloo world
def _rank_checks(rank, world, inputs):
    col = MetricCollection(_sync_bundle(tc, device="cpu"))
    states = col.init_states()
    for p, t in inputs["batches"][rank]:
        states = col.update_states(states, torch.from_numpy(p), torch.from_numpy(t))
    before = Counter(COLLECTIVES)
    synced = col.sync_states(states)
    counts = dict(Counter(COLLECTIVES) - before)
    return {"states": synced, "values": col.compute_states(synced), "collectives": counts}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    import torchmetrics_tpu.classification as jc
    from torchmetrics_tpu import MetricCollection as JaxCollection
    from torchmetrics_tpu.core.compile import shard_map

    batches = [[_batch(100 + 10 * r + k, rows=8) for k in range(2)] for r in range(WORLD)]
    results = run_world(__file__, {"batches": batches}, tmp_path_factory.mktemp("collection_world"), WORLD)

    jm = JaxCollection(_sync_bundle(jc))
    per_rank = []
    for r in range(WORLD):
        st = jm.init_states()
        for p, t in batches[r]:
            st = jm.update_states(st, jnp.asarray(p), jnp.asarray(t))
        per_rank.append(st)
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *per_rank)
    body = shard_map(lambda st: jm.sync_states(jax.tree.map(lambda x: x[0], st), "data"), mesh=mesh,
                     in_specs=(P("data"),), out_specs=P(), check_vma=False)
    synced = jax.jit(body)(stacked)
    return results, {"states": synced, "values": jm.compute_states(synced)}


def test_collection_sync_matches_jax(world):
    results, ref = world
    for r in results:
        _assert_results(r["values"], ref["values"])
        for name, want in ref["states"].items():
            got = r["states"][name]
            assert int(got["_n"]) == 2 * WORLD
            for k, w in want.items():
                if isinstance(w, tuple):  # cat rows: the global count, every rank's rows
                    assert got[k][0].shape[0] == sum(np.asarray(x).shape[0] for x in w) == 16 * WORLD
                else:
                    assert got[k].dtype == torch.int32
                    np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=f"{name}.{k}")


def test_collection_sync_is_one_plan(world):
    results, _ = world
    for r in results:
        # one int32 sum bucket for every leader's counts and `_n`; AP's three cat leaves gather
        assert r["collectives"] == {"all_reduce": 1, "all_gather": 3, "shape_gather": 3}


if __name__ == "__main__":
    worker_main(_rank_checks)
