"""The port's ragged pad-gather-trim, held against the JAX package's ``sync_ragged_states``.

One gloo world of 4 CPU ranks (``tests/helpers/torch_dist.py``) runs every
rank check of this file once. Each rank holds a different number of ROUGE
sentences and detection images; the JAX reference gathers the same
per-device states over 4 virtual devices in the parent. The synced items
must come back exactly (values, dtypes, shapes) and in rank order, so every
rank's item count is kept; ROUGE ``rtol=1e-6`` (float32 means in another
order) and mAP exactly (host numpy on the same items).

``test_dryrun_twin`` reproduces the metric legs of ``__graft_entry__._dryrun_impl``
(the synced Accuracy, F1 and exact AP) and of ``_dryrun_ragged_states``
(ROUGE and mAP on its own data) with 4 ranks.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.helpers.torch_dist import run_world, worker_main
from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassAveragePrecision, MulticlassF1Score
from torchmetrics_tpu_torch.detection import MeanAveragePrecision
from torchmetrics_tpu_torch.parallel import sync_ragged_states
from torchmetrics_tpu_torch.parallel.ragged import packed_int_dtype
from torchmetrics_tpu_torch.text import ROUGEScore
from torchmetrics_tpu_torch.utilities.exceptions import ReplicaDivergenceError

WORLD = 4
C = 8
VOCAB = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "fast", "home"]
LABEL_RANGES = {"detection_labels": (0, 90), "groundtruth_labels": (0, 90), "groundtruth_crowds": (0, 1)}


def _dryrun_sentences(d):
    """``__graft_entry__._dryrun_ragged_states``'s sentences of device ``d``."""
    k = d % 3 + 1
    tgt = [" ".join(VOCAB[(d + j) % 5 : (d + j) % 5 + 5]) for j in range(k)]
    return [" ".join(s.split()[:4]) for s in tgt], tgt


def _sentences(seed, n):
    rng = np.random.default_rng(seed)
    tgt = [" ".join(rng.choice(VOCAB, int(rng.integers(3, 9)))) for _ in range(n)]
    pred = [" ".join(rng.choice(VOCAB, int(rng.integers(2, 9)))) for _ in range(n)]
    return pred, tgt


def _dryrun_detections():
    """``_dryrun_ragged_states``'s images: one rng over the devices in turn."""
    rng = np.random.default_rng(0)
    out = []
    for d in range(WORLD):
        preds, targets = [], []
        for _ in range(d % 2 + 1):
            ng = int(rng.integers(1, 4))
            xy = rng.uniform(0, 50, (ng, 2))
            wh = rng.uniform(5, 30, (ng, 2))
            gb = np.concatenate([xy, xy + wh], 1).astype(np.float32)
            gl = rng.integers(0, 2, ng).astype(np.int32)
            preds.append({"boxes": gb + rng.normal(0, 2, gb.shape).astype(np.float32),
                          "scores": rng.uniform(0.2, 1, ng).astype(np.float32), "labels": gl})
            targets.append({"boxes": gb, "labels": gl})
        out.append((preds, targets))
    return out


def _detections(seed, n_img):
    """Images with crowds, user areas, empty images and ties in the scores."""
    rng = np.random.default_rng(seed)
    preds, targets = [], []
    for i in range(n_img):
        ng = int(rng.integers(0, 6))
        xy = rng.uniform(0, 150, (ng, 2))
        wh = rng.uniform(4, 120, (ng, 2))
        gb = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        gl = rng.integers(0, 4, ng).astype(np.int32)
        nd = int(rng.integers(0, 9))
        src = rng.integers(0, max(ng, 1), nd)
        db = (gb[src] if ng else rng.uniform(0, 100, (nd, 4)).astype(np.float32)) + rng.normal(0, 5, (nd, 4)).astype(np.float32)
        db[:, 2:] = np.maximum(db[:, 2:], db[:, :2] + 1)
        dl = (gl[src] if ng else rng.integers(0, 4, nd)).astype(np.int32)
        preds.append({"boxes": db.astype(np.float32), "scores": np.round(rng.uniform(0, 1, nd), 1).astype(np.float32),
                      "labels": dl})
        target = {"boxes": gb, "labels": gl, "iscrowd": (rng.uniform(size=ng) < 0.2).astype(np.int32)}
        if i % 3 == 0:
            target["area"] = rng.uniform(10, 20000, ng).astype(np.float32)
        targets.append(target)
    return preds, targets


def _rank_data(rank):
    return {
        "rouge": [_dryrun_sentences(rank), _sentences(50 + rank, rank + 1)],
        "map": [_dryrun_detections()[rank], _detections(60 + rank, 2 + 2 * rank)],
    }


def _metric_batch(rank):
    rng = np.random.default_rng(70 + rank)
    probs = rng.dirichlet(np.ones(C), size=4).astype(np.float32)  # batch 4 per data shard
    return probs, rng.integers(0, C, 4).astype(np.int32)


def _torch_det(items):
    return [{k: torch.from_numpy(v) for k, v in d.items()} for d in items]


def _rank_checks(rank, world, inputs):
    out = {}
    data = _rank_data(rank)
    rouge = ROUGEScore(rouge_keys=("rouge1", "rougeL"), device="cpu")
    st = rouge.init_state()
    out["rouge_empty"] = sync_ragged_states(rouge._reductions, st)
    for pred, tgt in data["rouge"]:
        st = rouge.update_state(st, pred, tgt)
    merged = sync_ragged_states(rouge._reductions, st, verify_consistency=True)
    out["rouge_state"], out["rouge_value"] = merged, rouge.compute_state(merged)

    m = MeanAveragePrecision(device="cpu", class_metrics=True)
    states = []
    for preds, targets in data["map"]:
        states.append(m.update_state(m.init_state(), _torch_det(preds), _torch_det(targets)))
    out["map_states"], out["map_values"] = [], []
    for st in states:
        merged = sync_ragged_states(m._reductions, st, value_ranges=LABEL_RANGES)
        out["map_states"].append(merged)
        out["map_values"].append(m.compute_state(merged))
    try:  # a declared range that the labels break raises on every rank
        sync_ragged_states(m._reductions, states[1], value_ranges={"groundtruth_labels": (0, 1)})
        out["range_refused"] = None
    except ValueError as err:
        out["range_refused"] = str(err)
    bad = dict(states[0], _n=torch.tensor(2 if rank == 0 else 1, dtype=torch.int32))
    try:
        sync_ragged_states(m._reductions, bad, verify_consistency=True)
        out["divergence"] = None
    except ReplicaDivergenceError as err:
        out["divergence"] = err.replicas

    # the metric leg of _dryrun_impl: Accuracy, F1 and exact AP synced over the data shards
    probs, target = (torch.from_numpy(x) for x in _metric_batch(rank))
    leg = {}
    for name, metric in (("acc", MulticlassAccuracy(num_classes=C, average="micro", validate_args=False, device="cpu")),
                         ("f1", MulticlassF1Score(num_classes=C, average="macro", validate_args=False, device="cpu")),
                         ("ap", MulticlassAveragePrecision(num_classes=C, thresholds=None, validate_args=False,
                                                           device="cpu"))):
        synced = metric.sync_states(metric.update_state(metric.init_state(), probs, target))
        leg[name] = {"n": int(synced["_n"]), "value": metric.compute_state(synced),
                     "rows": synced["preds"][0].shape[0] if name == "ap" else None}
    out["leg"] = leg
    return out


# ------------------------------------------------------------------ parent side
def _jax_det(items):
    import jax.numpy as jnp

    return [{k: jnp.asarray(v) for k, v in d.items()} for d in items]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    import __graft_entry__
    from torchmetrics_tpu import classification as jc
    from torchmetrics_tpu.core.compile import shard_map
    from torchmetrics_tpu.detection import MeanAveragePrecision as JaxMAP
    from torchmetrics_tpu.parallel import sync_ragged_states as jax_sync_ragged
    from torchmetrics_tpu.text import ROUGEScore as JaxROUGE

    results = run_world(__file__, {}, tmp_path_factory.mktemp("ragged_world"), WORLD)
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    data = [_rank_data(r) for r in range(WORLD)]

    rouge = JaxROUGE(rouge_keys=("rouge1", "rougeL"))
    states = []
    for d in data:
        st = rouge.init_state()
        for pred, tgt in d["rouge"]:
            st = rouge.update_state(st, pred, tgt)
        states.append(st)
    merged = jax_sync_ragged(rouge._reductions, states, mesh)
    ref = {"rouge_state": merged, "rouge_value": rouge.compute_state(merged)}

    m = JaxMAP(class_metrics=True)
    ref["map_states"], ref["map_values"] = [], []
    for k in range(2):
        states = [m.update_state(m.init_state(), _jax_det(d["map"][k][0]), _jax_det(d["map"][k][1])) for d in data]
        merged = jax_sync_ragged(m._reductions, states, mesh, value_ranges=LABEL_RANGES)
        ref["map_states"].append(merged)
        ref["map_values"].append(m.compute_state(merged))

    ref["dryrun_rouge_f"], ref["dryrun_map"] = __graft_entry__._dryrun_ragged_states(WORLD)
    leg = {}
    for name, metric in (("acc", jc.MulticlassAccuracy(num_classes=C, average="micro", validate_args=False)),
                         ("f1", jc.MulticlassF1Score(num_classes=C, average="macro", validate_args=False)),
                         ("ap", jc.MulticlassAveragePrecision(num_classes=C, thresholds=None, validate_args=False))):
        probs = jnp.asarray(np.concatenate([_metric_batch(r)[0] for r in range(WORLD)]))
        target = jnp.asarray(np.concatenate([_metric_batch(r)[1] for r in range(WORLD)]))
        body = shard_map(lambda p, t, metric=metric: metric.sync_states(metric.update_state(metric.init_state(), p, t), "data"),
                         mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P(), check_vma=False)
        leg[name] = float(np.nanmean(np.asarray(metric.compute_state(jax.jit(body)(probs, target)))))
    ref["leg"] = leg
    return results, ref


def _assert_items(got, want, name):
    assert isinstance(got, tuple) and len(got) == len(want), name
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.device.type == "cpu" and g.numpy().dtype == w.dtype and g.shape == w.shape, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_rouge_items_and_values_match_jax(world):
    results, ref = world
    for r in results:
        for name, want in ref["rouge_state"].items():
            if name == "_n":
                assert int(r["rouge_state"][name]) == int(want) == 2 * WORLD
            else:
                _assert_items(r["rouge_state"][name], want, name)
        for k, w in ref["rouge_value"].items():
            np.testing.assert_allclose(r["rouge_value"][k].numpy(), np.asarray(w), rtol=1e-6, err_msg=k)


def test_rouge_keeps_every_ranks_item_count(world):
    results, _ = world
    want = [len(_rank_data(rank)["rouge"][0][0]) for rank in range(WORLD)]  # the dryrun's 1..3 sentences a rank
    want = [n for rank in range(WORLD) for n in (want[rank], rank + 1)]  # two updates a rank, in rank order
    for r in results:
        assert [v.shape[0] for v in r["rouge_state"]["rouge1_fmeasure"]] == want
        assert r["rouge_empty"]["rouge1_fmeasure"] == () and int(r["rouge_empty"]["_n"]) == 0


@pytest.mark.parametrize("case", [0, 1], ids=["dryrun_images", "crowds_areas_empty_images"])
def test_map_items_and_values_match_jax(world, case):
    results, ref = world
    want_state, want_value = ref["map_states"][case], ref["map_values"][case]
    for r in results:
        got = r["map_states"][case]
        for name, want in want_state.items():
            if name == "_n":
                assert int(got[name]) == int(want) == WORLD
            else:
                _assert_items(got[name], want, name)
        for k, w in want_value.items():
            np.testing.assert_array_equal(r["map_values"][case][k].numpy(), np.asarray(w), err_msg=k)


def test_map_keeps_every_ranks_image_count(world):
    results, _ = world
    counts = [[len(_rank_data(rank)["map"][k][0]) for rank in range(WORLD)] for k in range(2)]
    assert counts == [[1, 2, 1, 2], [2, 4, 6, 8]]
    for r in results:
        for k in range(2):
            assert len(r["map_states"][k]["detection_scores"]) == sum(counts[k])
            assert len(r["map_states"][k]["groundtruth_boxes"]) == sum(counts[k])


def test_refusals_are_collective(world):
    results, _ = world
    for r in results:
        assert r["range_refused"] and "groundtruth_labels" in r["range_refused"]
        assert r["divergence"] == (0,)


def test_dryrun_twin(world):
    results, ref = world
    for r in results:
        assert {r["leg"][k]["n"] for k in r["leg"]} == {WORLD}  # one synced update per data shard
        assert r["leg"]["ap"]["rows"] == 4 * WORLD  # the cat gather holds every shard's rows
        for name, want in ref["leg"].items():
            value = float(r["leg"][name]["value"])
            assert 0.0 <= value <= 1.0
            np.testing.assert_allclose(value, want, atol=1e-6, err_msg=name)
        assert len(r["rouge_state"]["rouge1_fmeasure"]) == 2 * WORLD
        assert len(r["map_states"][0]["detection_scores"]) == sum(d % 2 + 1 for d in range(WORLD))
    # the port on the dryrun's own ragged data (its first update a rank) gives the dryrun's numbers
    rouge = ROUGEScore(rouge_keys=("rouge1", "rougeL"), device="cpu")
    first = {k: tuple(v[2 * rank] for rank in range(WORLD)) for k, v in results[0]["rouge_state"].items() if k != "_n"}
    first["_n"] = torch.tensor(WORLD, dtype=torch.int32)
    np.testing.assert_allclose(float(rouge.compute_state(first)["rouge1_fmeasure"]), ref["dryrun_rouge_f"], rtol=1e-6)
    np.testing.assert_allclose(float(results[0]["map_values"][0]["map"]), ref["dryrun_map"], rtol=0, atol=0)


def test_bitpacked_wire_types():
    assert packed_int_dtype(torch.int32, (0, 90)) == torch.uint8
    assert packed_int_dtype(torch.int32, (-3, 90)) == torch.int8
    assert packed_int_dtype(torch.int32, (0, 50_000)) == torch.int32
    assert packed_int_dtype(torch.float32, (0, 1)) == torch.float32


def test_deferred_options_raise():
    """The two-stage route and ``owner`` are ported: an unknown route raises JAX's ``ValueError``."""
    from torchmetrics_tpu_torch.parallel import DeferredRaggedSync

    state = {"items": (torch.ones(2),), "_n": torch.tensor(1, dtype=torch.int32)}
    with pytest.raises(ValueError, match="route"):
        sync_ragged_states({"items": "cat"}, state, route="hierarchical")
    with pytest.raises(ValueError, match="route"):
        DeferredRaggedSync(route="hierarchical")
    out = sync_ragged_states({"items": "cat"}, state, route="two_stage", owner=object())  # one process: flat
    assert [tuple(v.shape) for v in out["items"]] == [(2,)] and int(out["_n"]) == 1


if __name__ == "__main__":
    worker_main(_rank_checks)
