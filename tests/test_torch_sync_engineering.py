"""The port's sync engineering, held against the JAX package's in a gloo world of 4 ranks.

One gloo world of 4 CPU processes (``tests/helpers/torch_dist.py``) runs
every rank check of this file once; the JAX references run in the parent,
under ``shard_map`` over 4 of ``tests/conftest.py``'s 8 CPU devices, on the
same numpy inputs: rank r's data is device r's.

What is held, and how closely:

* the compressed collectives: ``psum_int8`` and ``psum_scatter_int8`` (the
  codec's plain version, the port's CPU path) bit for bit against JAX's,
  ``psum_bf16`` and ``psum_scatter_bf16`` within ``2**-8`` of each chunk's
  largest magnitude (gloo and XLA add the bfloat16 copies in other orders and
  places of rounding), the exact reduce-scatter of gaussian rows within
  ``1e-6`` of the block's largest magnitude (a float32 sum in another order);
  the collectives each launches counted;
* the plans of FID's table (sharded cov sums, int8), the eval collection and
  a mixed table field for field against JAX's (parent side);
* the sharded sync: each rank's block against JAX's per-device block
  (``out_specs`` ``P("data")``), 10 features over 4 ranks (padded to 12);
  compute after the gather equal, bit for bit, to the compute on the
  replicated sync, for a vector sum and for FID (integer-valued rows, so
  that every float32 sum is exact in any order); FID's int8 sharded cov
  sums bit for bit JAX's blocks and within one quantization stage (``1/127``
  of each chunk's largest value) of the exact sums;
* the quarantine weight (rank 2 out): sum, min, max and MEAN leaves against
  JAX's ``apply_sync_plan(weight=)`` (floats ``rtol=1e-6``, the rest exact)
  and against the other ranks' own combination;
* ``SyncStepper``, ``sharded_update(sync_policy=)``,
  ``sharded_collection_update``, ``flush_sync``, ``cadence_stepper``'s
  refusal, snapshot and restore (and the refusal of another world size): the
  deferred windows equal the every-step sync bit for bit (integer counts),
  the values equal JAX's within ``rtol=1e-6``;
* ``DeferredRaggedSync`` (one metric, and mAP with ROUGE in one gather a
  dtype), ``sharded_list_update`` and the two-stage route with an injected
  ``dcn_allgather``: items exactly, values as in ``test_torch_ragged.py``;
* Pearson through ``coalesced_metric_sync``: exact under a compression, a
  ``TypeError`` under a weight, as in JAX.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

from tests.helpers.torch_dist import run_world, worker_main
from tests.test_torch_ragged import LABEL_RANGES, _rank_data, _torch_det
from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassAUROC, MulticlassF1Score
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.core.reductions import COLLECTIVES, ShardSpec
from torchmetrics_tpu_torch.detection import MeanAveragePrecision
from torchmetrics_tpu_torch.image import FrechetInceptionDistance
from torchmetrics_tpu_torch.parallel import (
    DeferredRaggedSync,
    SyncPolicy,
    SyncStepper,
    cadence_stepper,
    coalesced_metric_sync,
    coalesced_sync_state,
    flush_sync,
    sharded_collection_update,
    sharded_list_update,
    sharded_update,
    sync_ragged_states,
)
from torchmetrics_tpu_torch.parallel import compress as tcomp
from torchmetrics_tpu_torch.regression import MeanSquaredError, PearsonCorrCoef
from torchmetrics_tpu_torch.text import ROUGEScore
from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError

WORLD = 4
C = 5  # classes of the eval collection
FID_DIM = 32
VEC_DIM = 10  # not a multiple of the world size: padded to 12, blocks of 3
WEIGHTS = (1.0, 1.0, 0.0, 1.0)  # rank 2 is quarantined
STEPS = 7
FLAT, SCATTER_COLS = 3000, 700


# ----------------------------------------------------------- shared inputs
def _flat(rank):
    rng = np.random.default_rng(10 + rank)
    return (rng.normal(size=FLAT) * 10.0 ** rng.integers(-2, 3, FLAT // 100).repeat(100)).astype(np.float32)


def _mat(rank):
    return np.random.default_rng(20 + rank).normal(scale=5.0, size=(WORLD, SCATTER_COLS)).astype(np.float32)


def _vec_rows(rank):
    """Integer-valued rows: every float32 sum of them is exact, in any order (gloo's and XLA's alike)."""
    return np.random.default_rng(30 + rank).integers(-8, 9, (rank + 2, VEC_DIM)).astype(np.float32)


def _fid_rows(rank, real):
    """Integer-valued features, a different number of rows a rank: the moment sums are exact in any order."""
    rng = np.random.default_rng(40 + rank + (0 if real else 100))
    return (rng.integers(-4, 5, (3 + 2 * rank, FID_DIM)) + (0 if real else 1)).astype(np.float32)


def _weight_state(rank):
    rng = np.random.default_rng(50 + rank)
    return {"s": rng.normal(size=(6,)).astype(np.float32), "si": rng.integers(-5, 9, (2, 3)).astype(np.int32),
            "m": rng.normal(size=(4,)).astype(np.float32), "lo": rng.normal(size=(3,)).astype(np.float32),
            "hi": rng.integers(-50, 50, (3,)).astype(np.int32), "_n": np.asarray(rank + 1, np.int32)}


WEIGHT_TABLE = {"s": "sum", "si": "sum", "m": "mean", "lo": "min", "hi": "max"}


def _cls_steps():
    """STEPS global batches of 4 * 6 rows; rank r takes rows [6r, 6r + 6) of each."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        logits = rng.normal(size=(WORLD * 6, C)).astype(np.float32)
        probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
        out.append((probs, rng.integers(0, C, WORLD * 6).astype(np.int32)))
    return out


def _pearson_rows(rank):
    rng = np.random.default_rng(60 + rank)
    x = rng.normal(size=(5 + rank,)).astype(np.float32)
    return x, (x * 0.7 + rng.normal(scale=0.3, size=x.shape)).astype(np.float32)


def _extractor(dim):
    def extractor(x):
        return x

    extractor.num_features = dim
    return extractor


class VecSum(Metric):
    """A vector sum and a count; the vector optionally sharded."""

    def __init__(self, dim=VEC_DIM, sharding=None, **kwargs):
        super().__init__(**kwargs)
        self.add_state("vec", torch.zeros(dim), dist_reduce_fx="sum", state_sharding=sharding)
        self.add_state("count", torch.zeros(()), dist_reduce_fx="sum")

    def _update(self, state, x):
        return {"vec": state["vec"] + x.sum(0), "count": state["count"] + x.shape[0]}

    def _compute(self, state):
        return state["vec"] / state["count"]


def _eval_collection(pkg, **device):
    return pkg_collection(pkg)({
        "acc": pkg.MulticlassAccuracy(num_classes=C, average="micro", validate_args=False, **device),
        "f1": pkg.MulticlassF1Score(num_classes=C, average="macro", validate_args=False, **device),
        "auroc": pkg.MulticlassAUROC(num_classes=C, thresholds=20, validate_args=False, **device),
    }, compute_groups=False)


def pkg_collection(pkg):
    if pkg.__name__.startswith("torchmetrics_tpu_torch"):
        return MetricCollection
    from torchmetrics_tpu import MetricCollection as JaxCollection

    return JaxCollection


def _delta(before):
    return dict(Counter(COLLECTIVES) - before)


# -------------------------------------------------------------- the ranks
def _rank_checks(rank, world, inputs):
    import torchmetrics_tpu_torch.classification as tc

    out = {}
    # --- the compressed collectives
    flat, mat = torch.from_numpy(_flat(rank)), torch.from_numpy(_mat(rank))
    coll = {}
    for name, fn in (("bf16", lambda: tcomp.psum_bf16(flat)), ("int8_256", lambda: tcomp.psum_int8(flat, 256)),
                     ("int8_64", lambda: tcomp.psum_int8(flat, 64)),
                     ("scatter_bf16", lambda: tcomp.psum_scatter_bf16(mat)),
                     ("scatter_int8", lambda: tcomp.psum_scatter_int8(mat, 64)),
                     ("scatter_exact", lambda: coalesced_sync_state(
                         {"x": mat.T.contiguous()}, {"x": "sum"}, shardings={"x": ShardSpec(1)})["x"].T)):
        before = Counter(COLLECTIVES)
        out[name] = fn()
        coll[name] = _delta(before)
    out["collectives"] = coll

    # --- sharded syncs: blocks, compute after the gather, FID
    x = torch.from_numpy(_vec_rows(rank))
    rep, shd = VecSum(device="cpu"), VecSum(sharding="sharded", device="cpu")
    before = Counter(COLLECTIVES)
    out["vec_rep"] = rep.sync_states(rep.update_state(rep.init_state(), x))
    out["vec_shd"] = shd.sync_states(shd.update_state(shd.init_state(), x))
    out["vec_sync_collectives"] = _delta(before)
    before = Counter(COLLECTIVES)
    out["vec_values"] = (rep.compute_state(out["vec_rep"]), shd.compute_state(out["vec_shd"]))
    out["vec_compute_collectives"] = _delta(before)
    out["vec_merged"] = shd.compute_state(shd.merge_states(out["vec_shd"], out["vec_shd"]))
    fids = {}
    for mode in ("replicated", "sharded", "sharded_int8"):
        fid = FrechetInceptionDistance(feature=_extractor(FID_DIM), device="cpu")
        if mode != "replicated":
            fid.set_state_sharding("real_features_cov_sum", "sharded")
            fid.set_state_sharding("fake_features_cov_sum", ShardSpec(axis=0))
        st = fid.update_state(fid.init_state(), torch.from_numpy(_fid_rows(rank, True)), True)
        st = fid.update_state(st, torch.from_numpy(_fid_rows(rank, False)), False)
        comp = tcomp.CompressionConfig("int8", min_bucket_bytes=0, chunk=64) if mode == "sharded_int8" else None
        synced = fid.sync_states(st, compression=comp)
        fids[mode] = (synced, fid.compute_state(synced), fid._unpad_sharded(synced))
    out["fid"] = fids

    # --- the quarantine weight
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in _weight_state(rank).items()}
    w = WEIGHTS[rank]
    out["weighted"] = coalesced_sync_state(state, WEIGHT_TABLE, weight=torch.tensor(w))
    out["weighted_shd"] = shd.sync_states(shd.update_state(shd.init_state(), x), weight=w)
    try:
        coalesced_sync_state({"c": (torch.ones(2),), "_n": state["_n"]}, {"c": "cat"}, weight=w)
        out["weight_cat"] = None
    except ValueError as err:
        out["weight_cat"] = str(err)

    # --- cadence: every-step sync against every_n_steps=3, at_compute, snapshot/restore, flush
    steps = [(torch.from_numpy(p[6 * rank : 6 * rank + 6]), torch.from_numpy(t[6 * rank : 6 * rank + 6]))
             for p, t in inputs["cls_steps"]]
    cadenced, per_step = _eval_collection(tc, device="cpu"), _eval_collection(tc, device="cpu")
    ref, returned = None, []
    for p, t in steps:
        got = sharded_collection_update(cadenced, p, t, sync_policy=SyncPolicy(every_n_steps=3))
        returned.append(None if got is None else {k: {l: v.clone() for l, v in s.items()} for k, s in got.items()})
        synced = sharded_collection_update(per_step, p, t)
        ref = synced if ref is None else per_step.merge_states(ref, synced)
        if got is not None:
            out.setdefault("cadence_equal_at_sync", []).append(
                all(torch.equal(got[k][l], ref[k][l]) for k in ref for l in ref[k]))
    final = flush_sync(cadenced)
    out["cadence_returned"] = [r is not None for r in returned]
    out["cadence_final_equal"] = all(torch.equal(final[k][l], ref[k][l]) for k in ref for l in ref[k])
    out["cadence_values"] = per_step.compute_states(final)
    try:
        cadence_stepper(cadenced, SyncPolicy(every_n_steps=2))
        out["cadence_refused"] = None
    except ValueError as err:
        out["cadence_refused"] = str(err)

    stepper = SyncStepper(_eval_collection(tc, device="cpu"), policy=SyncPolicy(at_compute=True))
    assert all(stepper.update(p, t) is None for p, t in steps)
    out["at_compute_values"] = stepper.compute()
    out["at_compute_counts"] = (stepper.steps, stepper.pending)

    policy = SyncPolicy(every_n_steps=3)
    stepper = SyncStepper(_eval_collection(tc, device="cpu"), policy=policy)
    for p, t in steps[:5]:
        stepper.update(p, t)
    snap = stepper.snapshot()
    out["snap_pending"] = stepper.pending
    for p, t in steps[5:]:
        stepper.update(p, t)
    want = stepper.compute()
    restored = SyncStepper(_eval_collection(tc, device="cpu"), policy=policy)
    restored.restore(snap)
    for p, t in steps[5:]:
        restored.update(p, t)
    got = restored.compute()
    out["restore_equal"] = all(torch.equal(got[k], want[k]) for k in want)
    try:
        SyncStepper(_eval_collection(tc, device="cpu"), policy=policy).restore(dict(snap, n_devices=2))
        out["mesh_shape"] = None
    except StateRestoreError as err:
        out["mesh_shape"] = (err.reason, err.mesh_shape)

    acc = MulticlassAccuracy(num_classes=C, average="micro", device="cpu")
    single = [sharded_update(acc, p, t, sync_policy=SyncPolicy(every_n_steps=2)) for p, t in steps]
    out["single_returned"] = [s is not None for s in single]
    out["single_flush"] = flush_sync(acc)
    try:
        flush_sync(MulticlassAccuracy(num_classes=C, device="cpu"))
        out["flush_refused"] = False
    except RuntimeError:
        out["flush_refused"] = True

    # a sharded leaf's deferred carry: every_n_steps=2 over 3 steps
    shd2, rep2 = VecSum(sharding="sharded", device="cpu"), VecSum(device="cpu")
    policy2 = SyncPolicy(every_n_steps=2)
    for k in range(3):
        xs = x * (k + 1)
        sharded_update(shd2, xs, sync_policy=policy2)
        sharded_update(rep2, xs, sync_policy=policy2)
    out["cadence_shd"] = (flush_sync(shd2), flush_sync(rep2))
    out["cadence_shd_values"] = (shd2.compute_state(out["cadence_shd"][0]), rep2.compute_state(out["cadence_shd"][1]))

    # --- the deferred ragged sync
    data = _rank_data(rank)
    rouge = ROUGEScore(rouge_keys=("rouge1", "rougeL"), device="cpu")
    alone = DeferredRaggedSync(rouge)
    for pred, tgt in data["rouge"]:
        alone.update(pred, tgt)
    out["deferred_rouge"] = alone.compute()
    m = MeanAveragePrecision(device="cpu")
    m._value_ranges.update(LABEL_RANGES)
    shared = DeferredRaggedSync()
    shared.register(m, "map")
    shared.register(rouge, "rouge")
    for (pred, tgt), (dp, dt) in zip(data["rouge"], data["map"]):
        shared.update_for("rouge", pred, tgt)
        shared.update_for("map", _torch_det(dp), _torch_det(dt))
    before = Counter(COLLECTIVES)
    synced = shared.sync()
    out["deferred_collectives"] = _delta(before)
    out["deferred_shared"] = synced
    out["deferred_values"] = {k: shared._members[k].compute_state(v) for k, v in synced.items()}
    out["list_update"] = sharded_list_update(rouge, *data["rouge"][1])
    st = rouge.update_state(rouge.init_state(), *data["rouge"][1])
    out["two_stage"] = sync_ragged_states(rouge._reductions, st, route="two_stage", n_processes=2,
                                          dcn_allgather=lambda v: torch.stack([v, v]))

    # --- Pearson through the coalesced metric sync
    px, py = (torch.from_numpy(v) for v in _pearson_rows(rank))
    pearson, mse = PearsonCorrCoef(device="cpu"), MeanSquaredError(device="cpu")
    states = [pearson.update_state(pearson.init_state(), px, py), mse.update_state(mse.init_state(), px, py)]
    comp = tcomp.CompressionConfig("int8", min_bucket_bytes=0)
    out["pearson_compressed"] = coalesced_metric_sync([pearson, mse], states, compression=comp)
    out["pearson_exact"] = pearson.sync_states(states[0])
    try:
        coalesced_metric_sync([pearson, mse], states, weight=1.0)
        out["pearson_weight"] = None
    except TypeError as err:
        out["pearson_weight"] = str(err)
    return out


# ------------------------------------------------------------ parent side
def _jax_run(per_rank, fn, out_specs=None):
    """``fn(*leaves)`` under shard_map over 4 devices, device r holding ``per_rank[r]``; numpy out."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from torchmetrics_tpu.core.compile import shard_map

    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    stacked = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *per_rank)
    body = shard_map(lambda st: fn(jax.tree.map(lambda v: v[0], st)), mesh=mesh, in_specs=(P("data"),),
                     out_specs=P() if out_specs is None else out_specs, check_vma=False)
    return jax.tree.map(np.asarray, jax.jit(body)(stacked))


def _jax_metric_state(metric, updates):
    st = metric.init_state()
    for args in updates:
        st = metric.update_state(st, *args)
    return st


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu.parallel.compress as jcomp
    from torchmetrics_tpu import Metric as JaxMetric
    from torchmetrics_tpu.image import FrechetInceptionDistance as JaxFID
    from torchmetrics_tpu.parallel import DeferredRaggedSync as JaxDeferred
    from torchmetrics_tpu.parallel import metric_mesh, sharded_collection_update as jax_collection_update
    from torchmetrics_tpu.parallel import sharded_list_update as jax_list_update
    from torchmetrics_tpu.parallel.coalesce import apply_sync_plan, build_sync_plan
    from torchmetrics_tpu.core.reductions import Reduce
    from torchmetrics_tpu.detection import MeanAveragePrecision as JaxMAP
    from torchmetrics_tpu.text import ROUGEScore as JaxROUGE
    from tests.test_torch_ragged import _jax_det
    from torchmetrics_tpu.parallel import sync_ragged_states as jax_sync_ragged

    cls_steps = _cls_steps()
    results = run_world(__file__, {"cls_steps": cls_steps}, tmp_path_factory.mktemp("sync_engineering"), WORLD)
    ref = {}
    flats = [_flat(r) for r in range(WORLD)]
    mats = [_mat(r) for r in range(WORLD)]
    for name, spec in (("bf16", jcomp.CompressionSpec("bf16")), ("int8_256", jcomp.CompressionSpec("int8", 256)),
                       ("int8_64", jcomp.CompressionSpec("int8", 64))):
        ref[name] = _jax_run(flats, lambda v, spec=spec: jcomp.compressed_psum(v, "data", spec))
    ref["exact_psum"] = np.sum(np.stack(flats), 0)
    for name, spec in (("scatter_bf16", jcomp.CompressionSpec("bf16")), ("scatter_int8", jcomp.CompressionSpec("int8", 64))):
        ref[name] = _jax_run(mats, lambda v, spec=spec: jcomp.compressed_psum_scatter(v, "data", spec)[None],
                             out_specs=P("data"))
    import jax

    ref["scatter_exact"] = _jax_run(mats, lambda v: jax.lax.psum_scatter(v, "data", scatter_dimension=0,
                                                                         tiled=False)[None], out_specs=P("data"))

    class JaxVecSum(JaxMetric):
        def __init__(self, sharding=None, **kw):
            super().__init__(**kw)
            self.add_state("vec", jnp.zeros(VEC_DIM), dist_reduce_fx="sum", state_sharding=sharding)
            self.add_state("count", jnp.zeros(()), dist_reduce_fx="sum")

        def _update(self, state, x):
            return {"vec": state["vec"] + x.sum(0), "count": state["count"] + x.shape[0]}

        def _compute(self, state):
            return state["vec"] / state["count"]

    shd = JaxVecSum(sharding="sharded")
    vec_states = [shd.update_state(shd.init_state(), jnp.asarray(_vec_rows(r))) for r in range(WORLD)]
    ref["vec_shd"] = _jax_run(vec_states, lambda st: shd.sync_states(st, "data"), out_specs=shd.sync_out_specs("data"))
    ref["vec_rep"] = _jax_run(vec_states, lambda st: JaxVecSum().sync_states(st, "data"))
    mask = [np.asarray([w], np.float32) for w in WEIGHTS]
    ref["weighted_shd"] = _jax_run(list(zip(vec_states, mask)),
                                   lambda a: shd.sync_states(a[0], "data", None, a[1][0]),
                                   out_specs=shd.sync_out_specs("data"))

    table = {k: Reduce(v) for k, v in WEIGHT_TABLE.items()}
    wstates = [{k: jnp.asarray(v) for k, v in _weight_state(r).items()} for r in range(WORLD)]
    plan = build_sync_plan([(table, wstates[0])])
    ref["weighted"] = _jax_run(list(zip(wstates, mask)), lambda a: apply_sync_plan(plan, [a[0]], "data",
                                                                                      weight=a[1][0])[0])

    fid_refs = {}
    for mode in ("replicated", "sharded", "sharded_int8"):
        fid = JaxFID(feature=_extractor(FID_DIM))
        if mode != "replicated":
            fid.set_state_sharding("real_features_cov_sum", "sharded")
            fid.set_state_sharding("fake_features_cov_sum", "sharded")
        states = [_jax_metric_state(fid, [(jnp.asarray(_fid_rows(r, True)), True),
                                          (jnp.asarray(_fid_rows(r, False)), False)]) for r in range(WORLD)]
        comp = jcomp.CompressionConfig("int8", min_bucket_bytes=0, chunk=64) if mode == "sharded_int8" else None
        synced = _jax_run(states, lambda st, fid=fid, comp=comp: fid.sync_states(st, "data", comp),
                          out_specs=fid.sync_out_specs("data"))
        fid_refs[mode] = (synced, float(fid.compute_state({k: jnp.asarray(v) for k, v in synced.items()})))
    ref["fid"] = fid_refs

    mesh = metric_mesh(WORLD)
    jcol = _eval_collection(jc)
    cum = None
    for p, t in cls_steps:
        st = jax_collection_update(jcol, jnp.asarray(p), jnp.asarray(t), mesh=mesh)
        cum = st if cum is None else jcol.merge_states(cum, st)
    ref["cadence_values"] = {k: np.asarray(v) for k, v in jcol.compute_states(cum).items()}

    data = [_rank_data(r) for r in range(WORLD)]
    jrouge = JaxROUGE(rouge_keys=("rouge1", "rougeL"))
    alone = JaxDeferred(jrouge, mesh=mesh)
    for k in range(2):
        alone.update([data[r]["rouge"][k] for r in range(WORLD)])
    ref["deferred_rouge"] = {k: np.asarray(v) for k, v in alone.compute().items()}
    jmap = JaxMAP()
    shared = JaxDeferred(mesh=mesh)
    shared.register(jmap, "map")
    shared.register(jrouge, "rouge")
    for k in range(2):
        shared.update_for("rouge", [data[r]["rouge"][k] for r in range(WORLD)])
        shared.update_for("map", [(_jax_det(data[r]["map"][k][0]), _jax_det(data[r]["map"][k][1]))
                                  for r in range(WORLD)])
    ref["deferred_shared"] = shared.sync()
    ref["deferred_values"] = {k: shared._members[k].compute_state(v) for k, v in ref["deferred_shared"].items()}
    ref["list_update"] = jax_list_update(jrouge, [data[r]["rouge"][1] for r in range(WORLD)], mesh=mesh)
    rstates = [jrouge.update_state(jrouge.init_state(), *data[r]["rouge"][1]) for r in range(WORLD)]
    ref["two_stage"] = jax_sync_ragged(jrouge._reductions, rstates, mesh, route="two_stage", n_processes=2,
                                       dcn_allgather=lambda v: np.stack([np.asarray(v), np.asarray(v)]))
    return results, ref


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _chunk_bound(want, chunk, stages):
    """Per element: ``stages * 1/127`` (int8) of the largest magnitude of its chunk of the exact result."""
    flat = np.abs(np.asarray(want, np.float64)).reshape(-1)
    pad = -flat.size % chunk
    amax = np.pad(flat, (0, pad)).reshape(-1, chunk).max(1).repeat(chunk)[: flat.size]
    return stages * amax / 127.0


# ------------------------------------------------------------------- tests
def test_every_rank_saw_the_world(world):
    results, _ = world
    assert len(results) == WORLD


@pytest.mark.parametrize("name", ["int8_256", "int8_64"])
def test_psum_int8_equals_jax_bit_for_bit(world, name):
    results, ref = world
    for r in results:
        np.testing.assert_array_equal(_bits(r[name].numpy()), _bits(ref[name]), err_msg=name)
        assert r["collectives"][name] == {"all_to_all": 1, "all_gather": 1}


def test_psum_bf16_within_its_bound(world):
    results, ref = world
    exact = ref["exact_psum"]
    for r in results:
        got = r["bf16"].numpy()
        assert got.dtype == np.float32 and r["collectives"]["bf16"] == {"all_reduce": 1}
        assert np.abs(got - ref["bf16"]).max() <= 2.0 ** -8 * np.abs(ref["bf16"]).max()
        assert np.all(np.abs(got - exact) <= 2.0 ** -8 * 4 * np.abs(exact).max() + 1e-30)


def test_psum_scatter_variants_equal_jax(world):
    results, ref = world
    for rank, r in enumerate(results):
        np.testing.assert_array_equal(_bits(r["scatter_int8"].numpy()), _bits(ref["scatter_int8"][rank]))
        want_exact = ref["scatter_exact"][rank]
        np.testing.assert_allclose(r["scatter_exact"].numpy()[0], want_exact, rtol=0,
                                   atol=1e-6 * np.abs(want_exact).max())
        want = ref["scatter_bf16"][rank]
        assert np.abs(r["scatter_bf16"].numpy() - want).max() <= 2.0 ** -8 * 4 * np.abs(want).max()
        assert r["collectives"]["scatter_int8"] == {"all_to_all": 1}
        assert r["collectives"]["scatter_bf16"] == {"reduce_scatter": 1}
        assert r["collectives"]["scatter_exact"] == {"reduce_scatter": 1}


def test_sharded_blocks_equal_jax_per_device_blocks(world):
    results, ref = world
    padded = -(-VEC_DIM // WORLD) * WORLD
    assert ref["vec_shd"]["vec"].shape == (padded,)
    for rank, r in enumerate(results):
        block = r["vec_shd"]["vec"].numpy()
        assert block.shape == (padded // WORLD,)
        np.testing.assert_allclose(block, ref["vec_shd"]["vec"][rank * 3 : rank * 3 + 3], rtol=1e-6)
        np.testing.assert_allclose(r["vec_rep"]["vec"].numpy(), ref["vec_rep"]["vec"], rtol=1e-6)
        assert float(r["vec_shd"]["count"]) == float(ref["vec_shd"]["count"])
        assert r["vec_sync_collectives"] == {"all_reduce": 2 + 2, "reduce_scatter": 1}  # two plans' buckets
        rep_value, shd_value = r["vec_values"]
        assert torch.equal(rep_value, shd_value)  # compute after the gather: bit for bit the replicated one
        assert r["vec_compute_collectives"] == {"all_gather": 1}
        assert torch.equal(r["vec_merged"], rep_value)  # block + block, gathered: the same mean


def test_fid_sharded_compute_equals_replicated(world):
    results, ref = world
    for r in results:
        (rep_state, rep_value, _), (shd_state, shd_value, shd_full) = r["fid"]["replicated"], r["fid"]["sharded"]
        assert torch.equal(rep_value, shd_value)
        for name in ("real_features_cov_sum", "fake_features_cov_sum"):
            assert shd_state[name].shape == (FID_DIM // WORLD, FID_DIM)
            assert torch.equal(shd_full[name], rep_state[name])
        np.testing.assert_allclose(float(rep_value), ref["fid"]["replicated"][1], rtol=1e-5)
        np.testing.assert_allclose(float(shd_value), ref["fid"]["sharded"][1], rtol=1e-5)


def test_fid_sharded_int8_within_one_stage(world):
    results, ref = world
    for rank, r in enumerate(results):
        full = r["fid"]["sharded_int8"][2]
        exact = r["fid"]["replicated"][0]
        for name in ("real_features_cov_sum", "fake_features_cov_sum"):
            got, want = full[name].numpy(), exact[name].numpy()
            # each rank's (8 x 32) block is one row of the reduce-scatter: chunks of 64 run along it
            for b in range(WORLD):
                g, w = got[8 * b : 8 * b + 8].reshape(-1), want[8 * b : 8 * b + 8].reshape(-1)
                bound = _chunk_bound(w, 64, stages=1) * 1.01 + 1e-6
                assert np.all(np.abs(g - w) <= bound), (name, b)
            jax_block = ref["fid"]["sharded_int8"][0][name][8 * rank : 8 * rank + 8]
            np.testing.assert_array_equal(_bits(r["fid"]["sharded_int8"][0][name].numpy()), _bits(jax_block))


def test_weight_mask_equals_jax(world):
    results, ref = world
    others = [r for r in range(WORLD) if WEIGHTS[r]]
    states = [_weight_state(r) for r in range(WORLD)]
    own = {"s": np.sum([states[r]["s"] for r in others], 0), "si": np.sum([states[r]["si"] for r in others], 0),
           "m": np.sum([states[r]["m"] for r in others], 0) / len(others),
           "lo": np.min([states[r]["lo"] for r in others], 0), "hi": np.max([states[r]["hi"] for r in others], 0),
           "_n": sum(r + 1 for r in others)}
    for rank, r in enumerate(results):
        for leaf, want in ref["weighted"].items():
            got = r["weighted"][leaf].numpy()
            assert got.dtype == want.dtype and got.shape == want.shape, leaf
            if got.dtype == np.float32 and leaf in ("s", "m"):
                np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=leaf)
                np.testing.assert_allclose(got, own[leaf], rtol=1e-6, err_msg=leaf)
            else:
                np.testing.assert_array_equal(got, want, err_msg=leaf)
                np.testing.assert_array_equal(got, own[leaf], err_msg=leaf)
        np.testing.assert_allclose(r["weighted_shd"]["vec"].numpy(), ref["weighted_shd"]["vec"][3 * rank : 3 * rank + 3],
                                   rtol=1e-6)
        assert float(r["weighted_shd"]["count"]) == float(ref["weighted_shd"]["count"])
        assert "passthrough" in r["weight_cat"]


def test_cadence_equals_every_step_sync(world):
    results, ref = world
    for r in results:
        assert r["cadence_returned"] == [False, False, True, False, False, True, False]
        assert r["cadence_equal_at_sync"] == [True, True] and r["cadence_final_equal"]
        for k, want in ref["cadence_values"].items():
            np.testing.assert_allclose(r["cadence_values"][k].numpy(), want, rtol=1e-6, err_msg=k)
            assert torch.equal(r["at_compute_values"][k], r["cadence_values"][k]), k
        assert r["at_compute_counts"] == (STEPS, 0)
        assert "changed mid-accumulation" in r["cadence_refused"]
        assert r["single_returned"] == [False, True] * 3 + [False]
        assert int(r["single_flush"]["_n"]) == STEPS * WORLD
        assert r["flush_refused"]


def test_snapshot_restore_and_the_mesh_shape_refusal(world):
    results, _ = world
    for r in results:
        assert r["snap_pending"] == 2 and r["restore_equal"]
        assert r["mesh_shape"] == ("mesh-shape", (2,))


def test_sharded_deferred_carry(world):
    results, _ = world
    for r in results:
        shd, rep = r["cadence_shd"]
        assert shd["vec"].shape == (3,) and rep["vec"].shape == (VEC_DIM,)
        assert torch.equal(r["cadence_shd_values"][0], r["cadence_shd_values"][1])


def _assert_items(got, want, name):
    assert isinstance(got, tuple) and len(got) == len(want), name
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_deferred_ragged_sync_equals_jax(world):
    results, ref = world
    for r in results:
        for k, w in ref["deferred_rouge"].items():
            np.testing.assert_allclose(r["deferred_rouge"][k].numpy(), w, rtol=1e-6, err_msg=k)
        for key in ("map", "rouge"):
            for leaf, want in ref["deferred_shared"][key].items():
                got = r["deferred_shared"][key][leaf]
                if isinstance(want, tuple):
                    _assert_items(got, want, f"{key}::{leaf}")
                else:
                    assert int(got) == int(want), leaf
        for k, w in ref["deferred_values"]["map"].items():
            np.testing.assert_array_equal(r["deferred_values"]["map"][k].numpy(), np.asarray(w), err_msg=k)
        for k, w in ref["deferred_values"]["rouge"].items():
            np.testing.assert_allclose(r["deferred_values"]["rouge"][k].numpy(), np.asarray(w), rtol=1e-6, err_msg=k)
        # one gather a wire type (float32: boxes, scores, areas, ROUGE's scores; uint8: the labels and crowds in
        # their declared ranges) and the shape tables' gather with its size exchange; one bucket of the counters
        assert r["deferred_collectives"] == {"all_gather": 2 + 1, "shape_gather": 1, "all_reduce": 1}


def test_sharded_list_update_and_two_stage_equal_jax(world):
    results, ref = world
    for r in results:
        for key in ("list_update", "two_stage"):
            for leaf, want in ref[key].items():
                got = r[key][leaf]
                if isinstance(want, tuple):
                    _assert_items(got, want, f"{key} {leaf}")
                else:
                    assert int(got) == int(want), (key, leaf)
        assert len(r["two_stage"]["rouge1_fmeasure"]) == 2 * len(r["list_update"]["rouge1_fmeasure"])


def test_pearson_through_the_coalesced_sync(world):
    results, _ = world
    for r in results:
        synced = r["pearson_compressed"][0]
        for k, v in r["pearson_exact"].items():
            assert torch.equal(synced[k], v), k  # the compression never reaches Pearson's own sync
        assert "takes no compression or weight" in r["pearson_weight"]


# -------------------------------------------------------- the plans (no world)
def _plan_fields(plan):
    return [(b.dtype, b.op, b.sharded, None if b.compression is None else
             (b.compression.mode, b.compression.chunk, b.compression.error_bound),
             [(s.entry, s.name, tuple(s.shape), s.size, s.mean, s.shard_axis) for s in b.slots], b.n_collectives)
            for b in plan.buckets], plan.n_collectives


@pytest.mark.parametrize("mode", [None, "bf16", "int8"])
@pytest.mark.parametrize("sharded", [False, True])
def test_fid_plan_equals_jax(mode, sharded):
    import jax.numpy as jnp

    import torchmetrics_tpu.parallel.compress as jcomp
    from torchmetrics_tpu.image import FrechetInceptionDistance as JaxFID
    from torchmetrics_tpu.parallel.coalesce import bucket_scatter_size as jax_scatter_size
    from torchmetrics_tpu.parallel.coalesce import plan_for_metric as jax_plan_for_metric
    from torchmetrics_tpu_torch.parallel.coalesce import bucket_scatter_size, plan_for_metric

    tfid, jfid = FrechetInceptionDistance(feature=_extractor(FID_DIM), device="cpu"), JaxFID(feature=_extractor(FID_DIM))
    if sharded:
        for m in (tfid, jfid):
            m.set_state_sharding("real_features_cov_sum", "sharded")
            m.set_state_sharding("fake_features_cov_sum", "sharded")
    tcfg = None if mode is None else tcomp.CompressionConfig(mode, min_bucket_bytes=0)
    jcfg = None if mode is None else jcomp.CompressionConfig(mode, min_bucket_bytes=0)
    got, want = plan_for_metric(tfid, compression=tcfg), jax_plan_for_metric(jfid, compression=jcfg)
    assert _plan_fields(got) == _plan_fields(want)
    for gb, wb in zip(got.buckets, want.buckets):
        for n in (1, 3, 4, 8):
            assert bucket_scatter_size(gb, n) == jax_scatter_size(wb, n)
    assert tfid.sync_out_specs() == {k: (ShardSpec(0) if sharded and "cov" in k else None)
                                     for k in [*tfid._reductions, "_n"]}
    del jnp


@pytest.mark.parametrize("mode", [None, "int8"])
def test_eval_collection_plan_equals_jax(mode):
    import jax.numpy as jnp

    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu.parallel.compress as jcomp
    import torchmetrics_tpu_torch.classification as tc
    from torchmetrics_tpu.parallel.coalesce import plan_for_metrics as jax_plan_for_metrics
    from torchmetrics_tpu_torch.parallel.coalesce import plan_for_metrics

    tcol, jcol = _eval_collection(tc, device="cpu"), _eval_collection(jc)
    tcfg = None if mode is None else tcomp.CompressionConfig(mode, min_bucket_bytes=0)
    jcfg = None if mode is None else jcomp.CompressionConfig(mode, min_bucket_bytes=0)
    names = list(tcol.init_states())
    got = plan_for_metrics([tcol[n] for n in names], [tcol[n].init_state() for n in names], compression=tcfg)
    want, standard = jax_plan_for_metrics([jcol[n] for n in names], [jcol[n].init_state() for n in names],
                                          compression=jcfg)
    assert standard == tuple(range(len(names)))
    assert _plan_fields(got) == _plan_fields(want)
    del jnp


def test_mixed_table_plan_with_shardings_equals_jax():
    import jax.numpy as jnp

    import torchmetrics_tpu.parallel.compress as jcomp
    from torchmetrics_tpu.core.reductions import Reduce, ShardSpec as JaxShardSpec
    from torchmetrics_tpu.parallel.coalesce import build_sync_plan as jax_build
    from torchmetrics_tpu_torch.parallel.coalesce import build_sync_plan

    shapes = {"a": ((40, 30), "sum"), "b": ((7, 5), "sum"), "m": ((9,), "mean"), "lo": ((2,), "min"),
              "i": ((3,), "sum"), "c": ((2,), "cat"), "_n": ((), "sum")}
    dtypes = {"i": np.int32, "_n": np.int32}
    state = {k: np.zeros(s, dtypes.get(k, np.float32)) for k, (s, _) in shapes.items()}
    table = {k: r for k, (_, r) in shapes.items() if k != "_n"}
    for shard in ({}, {"a": 0}, {"a": 1, "b": 0}):
        for mode in (None, "bf16", "int8"):
            tcfg = None if mode is None else tcomp.CompressionConfig(mode, min_bucket_bytes=64)
            jcfg = None if mode is None else jcomp.CompressionConfig(mode, min_bucket_bytes=64)
            got = build_sync_plan([(table, {k: torch.from_numpy(v) for k, v in state.items()})], compression=tcfg,
                                  shardings=[{k: ShardSpec(a) for k, a in shard.items()}] if shard else None)
            want = jax_build([({k: Reduce(v) for k, v in table.items()}, {k: jnp.asarray(v) for k, v in state.items()})],
                             compression=jcfg,
                             shardings=[{k: JaxShardSpec(a) for k, a in shard.items()}] if shard else None)
            assert _plan_fields(got) == _plan_fields(want), (shard, mode)


def test_sharding_api_matches_jax():
    from torchmetrics_tpu.core.reductions import ShardSpec as JaxShardSpec, canonical_sharding as jax_canonical
    from torchmetrics_tpu_torch.core.reductions import canonical_sharding

    for spec in (None, "replicated", "sharded"):
        got, want = canonical_sharding(spec), jax_canonical(spec)
        assert (got is None and want is None) or got.axis == want.axis
    assert canonical_sharding(ShardSpec(1)) == ShardSpec(1) and jax_canonical(JaxShardSpec(1)).axis == 1
    for bad in ("diagonal", 3):
        with pytest.raises(ValueError, match="state_sharding"):
            canonical_sharding(bad)
        with pytest.raises(ValueError, match="state_sharding"):
            jax_canonical(bad)
    with pytest.raises(ValueError, match="non-negative"):
        ShardSpec(-1)
    m = VecSum(sharding="sharded", device="cpu")
    assert m.state_shardings == {"vec": ShardSpec(0)}
    m.set_state_sharding("vec", "replicated")
    assert m.state_shardings == {}
    m.set_state_sharding("vec", ShardSpec(0))
    with pytest.raises(KeyError, match="not a registered state leaf"):
        m.set_state_sharding("nope", "sharded")
    with pytest.raises(ValueError, match="out of range"):
        VecSum(device="cpu").set_state_sharding("vec", ShardSpec(1))
    with pytest.raises(ValueError, match="dist_reduce_fx='sum'"):
        MulticlassAUROC(num_classes=3, thresholds=None, device="cpu").set_state_sharding("preds", "sharded")
    class OwnSync(VecSum):
        def sync_states(self, state, compression=None, weight=None):
            return state

    with pytest.raises(ValueError, match="overrides sync_states"):
        OwnSync(device="cpu").set_state_sharding("vec", "sharded")
    import pickle

    clone = pickle.loads(pickle.dumps(VecSum(sharding="sharded", device="cpu")))
    assert clone.state_shardings == {"vec": ShardSpec(0)}


def test_one_rank_sharded_sync_is_the_state():
    """Without a process group a sharded leaf's block is the whole leaf, and compute takes it as it is."""
    m = VecSum(sharding="sharded", device="cpu")
    x = torch.from_numpy(_vec_rows(0))
    st = m.update_state(m.init_state(), x)
    synced = m.sync_states(st)
    assert torch.equal(synced["vec"], st["vec"]) and torch.equal(m.compute_state(synced), m.compute_state(st))


def test_stepper_refusals():
    import torchmetrics_tpu_torch.classification as tc

    with pytest.raises(ValueError, match="DeferredRaggedSync"):
        SyncStepper(tc.MulticlassAUROC(num_classes=3, thresholds=None, device="cpu"))
    with pytest.raises(ValueError, match="DeferredRaggedSync"):
        sharded_collection_update(MetricCollection({"a": tc.MulticlassAUROC(num_classes=3, thresholds=None,
                                                                            device="cpu")}), torch.zeros(2, 3),
                                  torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="positional"):
        sharded_update(MulticlassF1Score(num_classes=3, device="cpu"), preds=torch.tensor([0]),
                       target=torch.tensor([0]), sync_policy=SyncPolicy(every_n_steps=2))
    with pytest.raises(RuntimeError, match="before any update"):
        SyncStepper(MulticlassAccuracy(num_classes=3, device="cpu")).sync()
    with pytest.raises(StateRestoreError, match="not a SyncStepper snapshot"):
        SyncStepper(MulticlassAccuracy(num_classes=3, device="cpu")).restore({"version": 99})
    with pytest.raises(ValueError, match="overrides sync_states"):
        DeferredRaggedSync(PearsonCorrCoef(device="cpu"))
    acc = MulticlassAccuracy(num_classes=3, device="cpu")
    shared = DeferredRaggedSync()
    assert shared.register(acc, "a") == "a" and shared.register(acc, "a") == "a"
    with pytest.raises(ValueError, match="already registered"):
        shared.register(MulticlassAccuracy(num_classes=3, device="cpu"), "a")
    with pytest.raises(ValueError, match="namespace"):
        shared.register(MulticlassAccuracy(num_classes=3, device="cpu"), "a::b")


if __name__ == "__main__":
    worker_main(_rank_checks)
