"""The port's cross-rank sync, held against the JAX package's mesh sync.

One gloo world of 4 CPU ranks (``tests/helpers/torch_dist.py``) runs every
rank check of this file once; the JAX references run in the parent, under
``shard_map`` over 4 of the 8 virtual CPU devices that ``tests/conftest.py``
provides, on the same numpy inputs: rank r's state is device r's.

Tolerances: integer leaves exact and of JAX's dtype; float sums and means
``rtol=1e-6`` (the ranks' float32 sum is taken in another order than
XLA's); max, min, gathers and stacks exact. Cat states are compared as
multisets of rows: JAX gathers each update's element over the mesh (rows
interleave the devices per update), the port gathers each rank's rows once
(rank after rank). AP from the synced state ``atol=1e-6``.

The same world syncs the multimodal states: ``CLIPScore``'s two float32 sums
(``rtol=1e-6``, the count exact) and ``CLIPImageQualityAssessment``'s cat of
image features (as a multiset of rows, within ``atol=1e-6``: each package's
float32 encoder), on linear encoders of numpy weights, with their values (CLIP-IQA's probabilities sorted) within
``atol=1e-5``.

The same world also syncs the metrics whose sync is not a sum of leaves:
Pearson's moments (its own ``sync_states``, alone and inside a
``MetricCollection``; ranks hold different row counts), ``CatMetric``'s cat,
``MaxMetric``/``MinMetric``, and the exact ``BinaryAUROC``'s cat states.
Pearson's moments within ``rtol=1e-5`` (a float32 pairwise combine), its
value and the AUROC within ``atol=1e-6``.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

from tests.helpers.torch_dist import run_world, worker_main
from torchmetrics_tpu_torch import aggregation as tagg
from torchmetrics_tpu_torch.classification import (
    BinaryAUROC,
    MulticlassAccuracy,
    MulticlassAveragePrecision,
    MulticlassF1Score,
)
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.core.reductions import COLLECTIVES, Reduce, canonical_reduce, sync_leaf
from torchmetrics_tpu_torch.parallel import (
    build_sync_plan,
    coalesced_sync_state,
    distributed_available,
    gather_all_arrays,
    host_sync_state,
    sharded_update,
    sync_state,
)

WORLD = 4
C = 8  # classes, as in __graft_entry__._dryrun_impl
ROWS = 4  # rows a rank updates with, per update
LEAVES = {  # name: (reduction, dtype, shape)
    "sum_f": ("sum", np.float32, (3,)),
    "sum_i": ("sum", np.int32, (2, 2)),
    "mean_f": ("mean", np.float32, (4,)),
    "mean_i": ("mean", np.int32, (3,)),
    "max_f": ("max", np.float32, (5,)),
    "min_i": ("min", np.int32, (2,)),
    "cat_t": ("cat", np.float32, (2, 3)),
    "none_t": ("none", np.float32, (2,)),
    "fn": ("callable", np.float32, (3,)),
}


def _table(pkg):
    """The reduction table; the callable is the per-element spread over the ranks."""
    spread = (lambda x: x.amax(0) - x.amin(0)) if pkg == "torch" else (lambda x: x.max(0) - x.min(0))
    return {k: (spread if r == "callable" else r) for k, (r, _, _) in LEAVES.items()}


def _leaf_values(rank):
    rng = np.random.default_rng(100 + rank)
    out = {}
    for name, (_, dtype, shape) in LEAVES.items():
        out[name] = (rng.integers(-50, 50, shape) if dtype == np.int32 else rng.normal(size=shape)).astype(dtype)
    out["_n"] = np.int32(1)
    return out


def _metric_batches(rank):
    rng = np.random.default_rng(7 + rank)
    out = []
    for _ in range(2):  # two updates a rank
        logits = rng.normal(size=(ROWS, C)).astype(np.float32)
        logits[:, 3] = logits[:, 5]  # ties inside every row
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        out.append((probs.astype(np.float32), rng.integers(0, C, ROWS).astype(np.int32)))
    return out


def _port_metrics():
    return {
        "acc": MulticlassAccuracy(num_classes=C, average="micro", validate_args=False, device="cpu"),
        "f1": MulticlassF1Score(num_classes=C, average="macro", validate_args=False, device="cpu"),
        "ap": MulticlassAveragePrecision(num_classes=C, thresholds=None, validate_args=False, device="cpu"),
    }


SLICE6 = ("pearson", "cat", "max", "min", "auroc")


def _slice6_metrics(pkg):
    if pkg == "torch":
        from torchmetrics_tpu_torch.regression import PearsonCorrCoef

        agg, kw = tagg, {"device": "cpu"}
        auroc = BinaryAUROC(thresholds=None, **kw)
    else:
        from torchmetrics_tpu import aggregation as agg
        from torchmetrics_tpu.classification import BinaryAUROC as JaxBinaryAUROC
        from torchmetrics_tpu.regression import PearsonCorrCoef

        kw = {}
        auroc = JaxBinaryAUROC(thresholds=None)
    return {"pearson": PearsonCorrCoef(num_outputs=2, **kw), "cat": agg.CatMetric(**kw), "max": agg.MaxMetric(**kw),
            "min": agg.MinMetric(**kw), "auroc": auroc}


def _slice6_batches(rank):
    """Two updates a rank of each metric's inputs; Pearson's rows differ between the ranks."""
    rng = np.random.default_rng(50 + rank)
    out = {k: [] for k in SLICE6}
    for rows in ((rank + 1) * 3, 4):
        x = rng.normal(size=(rows, 2)).astype(np.float32)
        out["pearson"].append((x, (x + 0.5 * rng.normal(size=(rows, 2))).astype(np.float32)))
    for _ in range(2):
        out["cat"].append((rng.normal(size=3).astype(np.float32),))
        out["max"].append((rng.normal(size=5).astype(np.float32),))
        out["min"].append((rng.normal(size=5).astype(np.float32),))
        out["auroc"].append((np.round(rng.uniform(size=6), 1).astype(np.float32), rng.integers(0, 2, 6)))
    return out


MULTIMODAL = ("clip_score", "clip_iqa")
_IMAGE_W = np.random.default_rng(60).normal(size=(3, 6)).astype(np.float32)
_TEXT_TABLE = np.random.default_rng(61).normal(size=(5, 6)).astype(np.float32)


def _multimodal_metrics(pkg):
    """CLIPScore and CLIP-IQA on linear encoders: an image's channel means times a weight, a caption's row of a
    table by its length."""
    if pkg == "torch":
        from torchmetrics_tpu_torch.multimodal import CLIPImageQualityAssessment, CLIPScore

        xp, kw = torch, {"device": "cpu"}
        w, table = torch.from_numpy(_IMAGE_W), torch.from_numpy(_TEXT_TABLE)
    else:
        import jax.numpy as xp

        from torchmetrics_tpu.multimodal import CLIPImageQualityAssessment, CLIPScore

        kw, w, table = {}, xp.asarray(_IMAGE_W), xp.asarray(_TEXT_TABLE)
    enc = {"image_encoder": lambda imgs: imgs.mean((2, 3)) @ w,
           "text_encoder": lambda texts: table[xp.asarray([len(t) % 5 for t in texts])]}
    return {"clip_score": CLIPScore(**enc, **kw),
            "clip_iqa": CLIPImageQualityAssessment(prompts=("quality", "warm"), data_range=255.0, **enc, **kw)}


def _multimodal_batches(rank):
    """Two updates a rank, of 2 and 3 images of pixel scale, with captions of random lengths (the JAX mesh stacks
    the ranks' states: their shapes agree)."""
    rng = np.random.default_rng(70 + rank)
    out = []
    for n in (2, 3):
        captions = ["a" * int(k) for k in rng.integers(1, 9, n)]
        out.append((rng.uniform(0, 255, (n, 3, 4, 5)).astype(np.float32), captions))
    return out


def _rank_checks(rank, world, inputs):
    """Everything one rank does; the parent compares the results."""
    out = {"distributed": distributed_available()}
    table = {k: canonical_reduce(v) for k, v in _table("torch").items()}
    state = {k: torch.as_tensor(v) for k, v in _leaf_values(rank).items()}
    before = Counter(COLLECTIVES)
    out["coalesced"] = coalesced_sync_state(state, table)
    out["collectives"] = dict(Counter(COLLECTIVES) - before)
    plan = build_sync_plan([(table, state)])
    out["plan"] = {
        "n_collectives": plan.n_collectives, "n_shape_exchanges": plan.n_shape_exchanges,
        "buckets": [(b.dtype, b.op, [s.name for s in b.slots]) for b in plan.buckets],
        "passthrough": [name for _, name, _ in plan.passthrough],
    }
    out["per_leaf"] = {k: sync_leaf(table.get(k, Reduce.SUM), v) for k, v in state.items()}
    out["host"] = host_sync_state(state, table)
    out["sync_state"] = sync_state(state, table)

    # uneven gathers: rows per rank differ, and a list state that is empty on rank 1
    rng = np.random.default_rng(rank)
    uneven = torch.from_numpy(rng.normal(size=(rank + 1, 3)).astype(np.float32))
    items = tuple(torch.full((k + rank, 2), float(10 * rank + k)) for k in range(2 if rank != 1 else 0))
    out["cat_uneven"] = sync_leaf(Reduce.CAT, uneven)
    out["cat_list"] = sync_leaf(Reduce.CAT, items, torch.device("cpu"))
    out["gathered"] = gather_all_arrays(torch.arange((rank + 1) * (4 - rank), dtype=torch.int32).reshape(rank + 1, 4 - rank))
    try:
        gather_all_arrays(uneven, group="subgroup")
        out["group_refused"] = False
    except ValueError:
        out["group_refused"] = True

    # the metric leg of __graft_entry__._dryrun_impl: update on this rank's shard, then sync
    metrics = _port_metrics()
    synced, values = {}, {}
    for name, metric in metrics.items():
        st = metric.init_state()
        for probs, target in _metric_batches(rank):
            st = metric.update_state(st, torch.from_numpy(probs), torch.from_numpy(target))
        synced[name] = metric.sync_states(st)
        values[name] = metric.compute_state(synced[name])
    out["metric_states"], out["metric_values"] = synced, values
    probs, target = inputs["shard_probs"][rank], inputs["shard_target"][rank]
    out["sharded_update"] = sharded_update(metrics["acc"], torch.from_numpy(probs), torch.from_numpy(target))

    # metrics whose sync is not a sum of leaves
    out["slice6"] = {}
    batches = _slice6_batches(rank)
    for name, metric in _slice6_metrics("torch").items():
        st = metric.init_state()
        for args in batches[name]:
            st = metric.update_state(st, *map(torch.from_numpy, args))
        synced = metric.sync_states(st)
        out["slice6"][name] = (synced, metric.compute_state(synced))
    from torchmetrics_tpu_torch.regression import MeanAbsoluteError, PearsonCorrCoef, R2Score

    col = MetricCollection({"pearson": PearsonCorrCoef(num_outputs=2, device="cpu"),
                            "r2": R2Score(num_outputs=2, device="cpu"), "mae": MeanAbsoluteError(device="cpu")},
                           compute_groups=False)
    states = col.init_states()
    for args in batches["pearson"]:
        states = col.update_states(states, *map(torch.from_numpy, args))
    out["collection"] = col.sync_states(states)

    out["multimodal"] = {}
    for name, metric in _multimodal_metrics("torch").items():
        st = metric.init_state()
        for imgs, captions in _multimodal_batches(rank):
            args = (torch.from_numpy(imgs), captions) if name == "clip_score" else (torch.from_numpy(imgs),)
            st = metric.update_state(st, *args)
        synced = metric.sync_states(st)
        out["multimodal"][name] = (synced, metric.compute_state(synced))
    return out


# ------------------------------------------------------------------ parent side
def _jax_mesh_sync(per_rank_states, fn):
    """``fn(state)`` under shard_map over 4 devices, device r holding ``per_rank_states[r]``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from torchmetrics_tpu.core.compile import shard_map

    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    stacked = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *per_rank_states)
    body = shard_map(lambda st: fn(jax.tree.map(lambda x: x[0], st)), mesh=mesh, in_specs=(P("data"),),
                     out_specs=P(), check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(body)(stacked))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax.numpy as jnp

    from torchmetrics_tpu import classification as jc
    from torchmetrics_tpu.parallel import metric_mesh, sharded_update as jax_sharded_update
    from torchmetrics_tpu.parallel.coalesce import bucketed_collective_count
    from torchmetrics_tpu.parallel.sync import sync_state as jax_sync_state

    rng = np.random.default_rng(3)
    probs = rng.dirichlet(np.ones(C), size=4 * WORLD).astype(np.float32)
    target = rng.integers(0, C, 4 * WORLD).astype(np.int32)
    inputs = {"shard_probs": np.split(probs, WORLD), "shard_target": np.split(target, WORLD)}
    results = run_world(__file__, inputs, tmp_path_factory.mktemp("sync_world"), WORLD)

    table = _table("jax")
    leaf_states = [_leaf_values(r) for r in range(WORLD)]
    ref = {"leaves": _jax_mesh_sync(leaf_states, lambda st: jax_sync_state(st, table, "data"))}
    ref["count"] = bucketed_collective_count(table, {k: jnp.asarray(v) for k, v in leaf_states[0].items()})

    jmetrics = {
        "acc": jc.MulticlassAccuracy(num_classes=C, average="micro", validate_args=False),
        "f1": jc.MulticlassF1Score(num_classes=C, average="macro", validate_args=False),
        "ap": jc.MulticlassAveragePrecision(num_classes=C, thresholds=None, validate_args=False),
    }
    ref["metric_states"], ref["metric_values"] = {}, {}
    for name, m in jmetrics.items():
        states = []
        for r in range(WORLD):
            st = m.init_state()
            for p, t in _metric_batches(r):
                st = m.update_state(st, jnp.asarray(p), jnp.asarray(t))
            states.append(st)
        synced = _jax_mesh_sync(states, lambda st, m=m: m.sync_states(st, "data"))
        ref["metric_states"][name] = synced
        ref["metric_values"][name] = np.asarray(m.compute_state(jax_like(synced)))
    ref["slice6"] = {}
    for name, m in _slice6_metrics("jax").items():
        states = []
        for r in range(WORLD):
            st = m.init_state()
            for args in _slice6_batches(r)[name]:
                st = m.update_state(st, *map(jnp.asarray, args))
            states.append(st)
        synced = _jax_mesh_sync(states, lambda st, m=m: m.sync_states(st, "data"))
        ref["slice6"][name] = (synced, np.asarray(m.compute_state(jax_like(synced))))
    ref["multimodal"] = {}
    for name, m in _multimodal_metrics("jax").items():
        states = []
        for r in range(WORLD):
            st = m.init_state()
            for imgs, captions in _multimodal_batches(r):
                st = m.update_state(st, *((jnp.asarray(imgs), captions) if name == "clip_score" else
                                          (jnp.asarray(imgs),)))
            states.append(st)
        synced = _jax_mesh_sync(states, lambda st, m=m: m.sync_states(st, "data"))
        ref["multimodal"][name] = (synced, m.compute_state(jax_like(synced)))
    mesh = metric_mesh(WORLD)
    ref["sharded_update"] = jax_sharded_update(jmetrics["acc"], jnp.asarray(probs), jnp.asarray(target), mesh=mesh)
    return results, ref


def jax_like(state):
    import jax.numpy as jnp

    return {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple) else jnp.asarray(v)) for k, v in state.items()}


def _assert_leaf(got, want, name):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating) and name in ("sum_f", "mean_f"):
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_every_rank_saw_the_world(world):
    results, _ = world
    assert [r["distributed"] for r in results] == [True] * WORLD


@pytest.mark.parametrize("leaf", list(LEAVES) + ["_n"])
def test_coalesced_sync_matches_jax(world, leaf):
    results, ref = world
    for r in results:
        _assert_leaf(r["coalesced"][leaf], ref["leaves"][leaf], leaf)


@pytest.mark.parametrize("path", ["per_leaf", "host", "sync_state"])
def test_other_sync_paths_equal_the_coalesced_sync(world, path):
    results, _ = world
    for r in results:
        assert set(r[path]) == set(r["coalesced"])
        for k, v in r["coalesced"].items():
            assert r[path][k].dtype == v.dtype
            torch.testing.assert_close(r[path][k], v, rtol=1e-6, atol=0)


def test_collective_count_matches_jax_bucket_count(world):
    results, ref = world
    for r in results:
        plan, counts = r["plan"], r["collectives"]
        assert plan["n_collectives"] == ref["count"]
        assert counts["all_reduce"] + counts["all_gather"] == ref["count"]
        assert counts["shape_gather"] == plan["n_shape_exchanges"] == 3  # cat, none, callable
        # the int32 sum bucket carries `_n`; the int MEAN passes through (it comes back float32)
        assert plan["buckets"] == [
            ("float32", "max", ["max_f"]), ("float32", "sum", ["sum_f", "mean_f"]),
            ("int32", "min", ["min_i"]), ("int32", "sum", ["sum_i", "_n"]),
        ]
        assert plan["passthrough"] == ["mean_i", "cat_t", "none_t", "fn"]


def test_uneven_cat_gathers_in_rank_order(world):
    results, _ = world
    want = np.concatenate([np.random.default_rng(r).normal(size=(r + 1, 3)).astype(np.float32) for r in range(WORLD)])
    want_items = [np.full((k + r, 2), float(10 * r + k), np.float32) for r in range(WORLD) for k in range(2 if r != 1 else 0)]
    for r in results:
        np.testing.assert_array_equal(r["cat_uneven"].numpy(), want)
        assert isinstance(r["cat_list"], tuple) and len(r["cat_list"]) == 1
        np.testing.assert_array_equal(r["cat_list"][0].numpy(), np.concatenate(want_items))


def test_gather_all_arrays_pads_and_trims_every_dim(world):
    results, _ = world
    for r in results:
        assert r["group_refused"]
        for rank, g in enumerate(r["gathered"]):
            assert tuple(g.shape) == (rank + 1, 4 - rank) and g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy().ravel(), np.arange((rank + 1) * (4 - rank)))


def _rows(state):
    """A cat state's (preds | target | weight) rows, sorted: the multiset of rows."""
    cat = [np.concatenate([np.asarray(x) for x in state[k]]) for k in ("preds", "target", "weight")]
    rows = np.concatenate([cat[0], cat[1][:, None].astype(np.float32), cat[2][:, None]], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("name", ["acc", "f1", "ap"])
def test_metric_sync_matches_jax(world, name):
    results, ref = world
    want = ref["metric_states"][name]
    for r in results:
        got = r["metric_states"][name]
        assert set(got) == set(want)
        assert int(got["_n"]) == WORLD * 2 and got["_n"].dtype == torch.int32
        if name == "ap":
            assert got["preds"][0].shape == (2 * ROWS * WORLD, C)  # every rank's rows
            np.testing.assert_array_equal(_rows(got), _rows(want))
        else:
            for k, w in want.items():
                _assert_leaf(got[k], w, k)
        np.testing.assert_allclose(r["metric_values"][name].numpy(), ref["metric_values"][name], atol=1e-6)


def test_sharded_update_matches_jax(world):
    results, ref = world
    for r in results:
        for k, w in ref["sharded_update"].items():
            _assert_leaf(r["sharded_update"][k], w, k)


def test_one_rank_sync_applies_the_reductions():
    state = {"m": torch.tensor([1, 2], dtype=torch.int32), "s": torch.ones(2), "_n": torch.tensor(1, dtype=torch.int32)}
    out = sync_state(state, {"m": "mean", "s": "sum"})
    assert out["m"].dtype == torch.float32 and out["m"].tolist() == [1.0, 2.0]
    assert torch.equal(out["s"], state["s"]) and int(out["_n"]) == 1
    assert not distributed_available()


def test_deferred_options_raise():
    """Compression, the weight and shardings are ported; the divergence checks wait for the resilience slice."""
    from torchmetrics_tpu_torch.parallel import SyncPolicy, SyncStepper

    metric = MulticlassAccuracy(num_classes=3, device="cpu")
    for kwargs in ({"verify_consistency": True}, {"on_divergence": "quarantine"},
                   {"verify_consistency": True, "sync_policy": SyncPolicy(every_n_steps=2)}):
        with pytest.raises(NotImplementedError, match="item 9"):
            sharded_update(metric, torch.tensor([0]), torch.tensor([0]), **kwargs)
        with pytest.raises(NotImplementedError, match="item 9"):
            SyncStepper(metric, **{k: v for k, v in kwargs.items() if k != "sync_policy"})
    with pytest.raises(ValueError, match="on_divergence"):
        sharded_update(metric, torch.tensor([0]), torch.tensor([0]), on_divergence="ignore")


if __name__ == "__main__":
    worker_main(_rank_checks)


@pytest.mark.parametrize("name", SLICE6)
def test_non_sum_syncs_match_jax(world, name):
    results, ref = world
    want, want_value = ref["slice6"][name]
    for r in results:
        got, value = r["slice6"][name]
        assert set(got) == set(want)
        assert int(got["_n"]) == WORLD * 2 and got["_n"].dtype == torch.int32
        if name == "pearson":
            for k in ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total"):
                assert got[k].dtype == torch.float32 and got[k].shape == np.asarray(want[k]).shape
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6, err_msg=k)
            assert float(got["n_total"]) == sum((r_ + 1) * 3 + 4 for r_ in range(WORLD))
        elif name == "cat":  # rank after rank in the port, device-interleaved in JAX: the same values
            np.testing.assert_array_equal(np.sort(got["value"][0].numpy()),
                                          np.sort(np.concatenate([np.asarray(x) for x in want["value"]])))
        elif name == "auroc":
            np.testing.assert_array_equal(_rows_1d(got), _rows_1d(want))
        else:
            leaf = f"{name}_value"
            _assert_leaf(got[leaf], want[leaf], leaf)
        if name == "cat":  # its value is the gathered values, in each package's order
            value, want_value = np.sort(value.numpy()), np.sort(want_value)
        np.testing.assert_allclose(np.asarray(value), want_value, rtol=0, atol=1e-6)


def _rows_1d(state):
    rows = np.stack([np.concatenate([np.asarray(x, np.float32) for x in state[k]]) for k in ("preds", "target", "weight")], 1)
    return rows[np.lexsort(rows.T[::-1])]


def test_collection_sync_calls_pearsons_own_sync(world):
    results, _ = world
    for r in results:
        alone, _ = r["slice6"]["pearson"]
        synced = r["collection"]["pearson"]
        for k, v in alone.items():
            assert torch.equal(synced[k], v), k
        assert int(r["collection"]["r2"]["total"]) == sum((r_ + 1) * 3 + 4 for r_ in range(WORLD))
        assert int(r["collection"]["mae"]["_n"]) == WORLD * 2


@pytest.mark.parametrize("name", MULTIMODAL)
def test_multimodal_syncs_match_jax(world, name):
    results, ref = world
    want, want_value = ref["multimodal"][name]
    n_images = 5 * WORLD
    for r in results:
        got, value = r["multimodal"][name]
        assert set(got) == set(want)
        assert int(got["_n"]) == WORLD * 2 and got["_n"].dtype == torch.int32
        if name == "clip_score":
            for k in ("score", "n_samples"):
                assert got[k].dtype == torch.float32 and got[k].shape == ()
                np.testing.assert_allclose(float(got[k]), float(np.asarray(want[k])), rtol=1e-6, err_msg=k)
            assert float(got["n_samples"]) == n_images
            np.testing.assert_allclose(float(value), float(np.asarray(want_value)), rtol=0, atol=1e-5)
        else:  # one tensor of every rank's rows, rank after rank; JAX interleaves the devices per update
            rows = got["img_features"][0].numpy()
            want_rows = np.concatenate([np.asarray(x) for x in want["img_features"]])
            assert rows.shape == (n_images, 6)
            np.testing.assert_allclose(rows[np.lexsort(rows.T[::-1])], want_rows[np.lexsort(want_rows.T[::-1])],
                                       rtol=0, atol=1e-6)
            for k in ("quality", "warm"):
                np.testing.assert_allclose(np.sort(value[k].numpy()), np.sort(np.asarray(want_value[k])), rtol=0,
                                           atol=1e-5, err_msg=k)
