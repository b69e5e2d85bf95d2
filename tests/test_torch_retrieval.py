"""Parity of the port's retrieval metrics with the JAX package, and the ``retrieval_groups`` kernel's plan and model.

The same seeded numpy inputs go through both packages; the port runs on the
CPU, where every query's score is the plain version of the
``retrieval_groups`` kernel (``chip_smoke.py`` holds the kernel against it on
the card). Inputs: query ids negative and not contiguous, rows shuffled,
scores on a 0.1 grid (ties), NaN, +-inf and +-0.0 scores, queries with no
relevant and with every document relevant, graded targets for NDCG.

Tolerances: counts and the measures that are a count over a count
(precision, recall, hit rate, fall-out, R-precision, reciprocal rank) within
1e-6 relative (one float32 division of exact sums: equal in practice); AP,
NDCG and AUROC within 1e-6 relative (their float32 terms summed in another
order than XLA's); the aggregated class values within 1e-6 relative
(a float32 mean or median over the queries).
"""

import importlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.retrieval as jfr
import torchmetrics_tpu.retrieval as jr
import torchmetrics_tpu_torch.functional.retrieval as tfr
import torchmetrics_tpu_torch.retrieval as tr
from torchmetrics_tpu_torch.convert import state_from_jax
from torchmetrics_tpu_torch.kernels import retrieval as krt

jk = importlib.import_module("torchmetrics_tpu.functional.retrieval.kernels")
tk = importlib.import_module("torchmetrics_tpu_torch.functional.retrieval.kernels")

CPU = {"device": "cpu"}
RTOL, ATOL = 1e-6, 1e-7
F32 = np.float32


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=rtol, atol=atol, equal_nan=True)


def _data(seed, n_queries=7, docs=(1, 12), edits=(), graded=False):
    """Flat (preds, target, indexes) of ``n_queries`` queries of ``docs`` documents, rows shuffled,
    ids negative and not contiguous."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(docs[0], docs[1] + 1, n_queries)
    ids = np.repeat(rng.choice(np.arange(-40, 40, 3), n_queries, replace=False), sizes).astype(np.int32)
    n = ids.shape[0]
    preds = np.round(rng.uniform(size=n), 1).astype(F32)
    target = rng.integers(0, 4, n) if graded else (rng.uniform(size=n) < 0.4).astype(np.int64)
    if "edges" in edits:
        first = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        target[first[0]:first[0] + sizes[0]] = 0  # no relevant document
        if n_queries > 1:
            target[first[1]:first[1] + sizes[1]] = 1  # every document relevant
        preds[rng.uniform(size=n) < 0.1] = np.nan
        preds[rng.uniform(size=n) < 0.05] = np.inf
        preds[rng.uniform(size=n) < 0.05] = -np.inf
        zeros = rng.uniform(size=n) < 0.15
        preds[zeros] = np.where(rng.uniform(size=zeros.sum()) < 0.5, F32(0.0), F32(-0.0))
    order = rng.permutation(n)
    return preds[order], target[order], ids[order]


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# ----------------------------------------------------------------- single-query functions
SINGLE = ["retrieval_precision", "retrieval_recall", "retrieval_hit_rate", "retrieval_fall_out",
          "retrieval_average_precision", "retrieval_reciprocal_rank", "retrieval_normalized_dcg", "retrieval_auroc"]


@pytest.mark.parametrize("top_k", [None, 1, 3, 40])
@pytest.mark.parametrize("name", SINGLE)
@pytest.mark.parametrize("edits", [(), ("edges",)])
def test_single_query_functions(name, top_k, edits):
    p, t, _ = _data(3, n_queries=1, docs=(25, 25), edits=edits, graded=name == "retrieval_normalized_dcg")
    _close(getattr(tfr, name)(*_t(p, t), top_k=top_k), getattr(jfr, name)(*_j(p, t), top_k=top_k))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_r_precision_and_adaptive_precision(seed):
    p, t, _ = _data(seed, n_queries=1, docs=(9, 30), edits=("edges",))
    _close(tfr.retrieval_r_precision(*_t(p, t)), jfr.retrieval_r_precision(*_j(p, t)))
    for k in (2, 50):
        _close(tfr.retrieval_precision(*_t(p, t), top_k=k, adaptive_k=True),
               jfr.retrieval_precision(*_j(p, t), top_k=k, adaptive_k=True))


@pytest.mark.parametrize("max_k,adaptive_k", [(None, False), (4, False), (40, True), (4, True)])
def test_single_query_precision_recall_curve(max_k, adaptive_k):
    p, t, _ = _data(5, n_queries=1, docs=(20, 20))
    got = tfr.retrieval_precision_recall_curve(*_t(p, t), max_k=max_k, adaptive_k=adaptive_k)
    want = jfr.retrieval_precision_recall_curve(*_j(p, t), max_k=max_k, adaptive_k=adaptive_k)
    for g, w in zip(got, want):
        assert _np(g).dtype == np.asarray(w).dtype
        _close(g, w)


@pytest.mark.parametrize("top_k", [None, 8])
@pytest.mark.parametrize("max_fpr", [0.25, 1.0])
def test_single_query_auroc_max_fpr(max_fpr, top_k):
    p, t, _ = _data(6, n_queries=1, docs=(30, 30))
    _close(tfr.retrieval_auroc(*_t(p, t), top_k=top_k, max_fpr=max_fpr),
           jfr.retrieval_auroc(*_j(p, t), top_k=top_k, max_fpr=max_fpr), rtol=1e-5)


def test_single_query_errors_as_jax():
    p, t, _ = _data(7, n_queries=1, docs=(8, 8))
    bad = t.copy()
    bad[0] = 2
    for fn, args, kwargs in [
        ("retrieval_precision", (p, bad), {}), ("retrieval_precision", (p, t), {"top_k": 0}),
        ("retrieval_precision", (p, t), {"adaptive_k": 1}), ("retrieval_recall", (p, t), {"top_k": -1}),
        ("retrieval_precision_recall_curve", (p, t), {"max_k": 0}),
        ("retrieval_precision_recall_curve", (p, t), {"adaptive_k": "no"}),
        ("retrieval_auroc", (p, bad), {}), ("retrieval_r_precision", (p, bad), {}),
    ]:
        with pytest.raises(ValueError) as want:
            getattr(jfr, fn)(*_j(*args), **kwargs)
        with pytest.raises(ValueError, match=None) as got:
            getattr(tfr, fn)(*_t(*args), **kwargs)
        assert str(got.value) == str(want.value), fn


# ----------------------------------------------------------------- grouped measures (the plain version)
GROUPED = {
    "precision": lambda rg, k, a: jk.grouped_precision(rg, k, a),
    "recall": lambda rg, k, a: jk.grouped_recall(rg, k),
    "hit_rate": lambda rg, k, a: jk.grouped_hit_rate(rg, k),
    "fall_out": lambda rg, k, a: jk.grouped_fall_out(rg, k),
    "average_precision": lambda rg, k, a: jk.grouped_average_precision(rg, k),
    "reciprocal_rank": lambda rg, k, a: jk.grouped_reciprocal_rank(rg, k),
    "r_precision": lambda rg, k, a: jk.grouped_r_precision(rg),
    "auroc": lambda rg, k, a: jk.grouped_auroc(rg, k),
}


def _jax_scores(p, t, i, measure, top_k, adaptive):
    if measure == "ndcg":
        values, n_rel = jk.grouped_ndcg(*_j(p, t, i), top_k)
        rg = jk.rank_groups(*_j(p, t, i))
        return values, n_rel, rg.sizes
    rg = jk.rank_groups(*_j(p, t, i))
    return GROUPED[measure](rg, top_k, adaptive), rg.n_rel, rg.sizes


@pytest.mark.parametrize("top_k,adaptive", [(None, False), (1, False), (4, False), (4, True), (1000, True)])
@pytest.mark.parametrize("measure", sorted([*GROUPED, "ndcg"]))
@pytest.mark.parametrize("edits", [(), ("edges",)])
def test_grouped_scores_against_jax(measure, top_k, adaptive, edits):
    p, t, i = _data(11, n_queries=9, docs=(1, 30), edits=edits, graded=measure == "ndcg")
    got = tk.retrieval_scores(*_t(p, t, i), measure, top_k, adaptive)
    want = _jax_scores(p, t, i, measure, top_k, adaptive)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("edits", [(), ("edges",)])
def test_rank_groups_against_jax(edits):
    p, t, i = _data(12, n_queries=6, docs=(1, 20), edits=edits)
    got, want = tk.rank_groups(*_t(p, t, i)), jk.rank_groups(*_j(p, t, i))
    assert got.num_groups == want.num_groups
    for field in ("preds", "target", "gid", "rank", "wcum", "n_rel", "sizes"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert _np(g).dtype == w.dtype, field
        np.testing.assert_array_equal(_np(g), w, err_msg=field)
    for max_k, adaptive in ((5, False), (25, True)):
        for g, w in zip(tk.grouped_precision_recall_curve(got, max_k, adaptive),
                        jk.grouped_precision_recall_curve(want, max_k, adaptive)):
            _close(g, w)


@pytest.mark.parametrize("order", ["runs in order", "runs out of order", "an id in two runs", "rows shuffled"])
def test_query_layout_is_the_stable_sort_of_the_ids(order):
    """The glue's layout equals a stable sort of the query ids, whichever way the rows come: ids that
    never decrease (not copied) or in any other order (sorted by row)."""
    rng = np.random.default_rng(64)
    sizes = rng.integers(1, 9, 12)
    ids = rng.choice(np.arange(-40, 40, 3), 12, replace=False)
    if order == "runs in order":
        ids = np.sort(ids)
    if order == "an id in two runs":
        ids[5] = ids[2]
    rows = np.repeat(ids, sizes).astype(np.int32)
    if order == "rows shuffled":
        rows = rng.permutation(rows)
    p, t = rng.uniform(size=rows.shape).astype(F32), rng.integers(0, 2, rows.shape).astype(F32)
    inputs = _t(p, t, rows)
    got_p, got_t, offsets, longest = tk.query_layout(*inputs)
    assert (got_p.data_ptr() == inputs[0].data_ptr()) == (order == "runs in order")
    perm = np.argsort(rows, kind="stable")
    _, counts = np.unique(rows[perm], return_counts=True)
    np.testing.assert_array_equal(_np(got_p), p[perm])
    np.testing.assert_array_equal(_np(got_t), t[perm])
    np.testing.assert_array_equal(_np(offsets), np.concatenate([[0], np.cumsum(counts)]))
    assert longest == counts.max()


def test_empty_input_gives_one_group_of_zeros():
    z = np.zeros((0,), F32)
    for measure in ("precision", "auroc", "ndcg"):
        got = tk.retrieval_scores(*_t(z, z, z.astype(np.int32)), measure)
        for g in got:
            np.testing.assert_array_equal(_np(g), np.zeros(1, F32))


# ----------------------------------------------------------------- classes
CLASSES = {
    "RetrievalMAP": {}, "RetrievalMRR": {"top_k": 3}, "RetrievalPrecision": {"top_k": 4, "adaptive_k": True},
    "RetrievalRecall": {"top_k": 2}, "RetrievalHitRate": {"top_k": 1}, "RetrievalFallOut": {"top_k": 5},
    "RetrievalRPrecision": {}, "RetrievalNormalizedDCG": {"top_k": 6}, "RetrievalAUROC": {},
}


def _drive(cls, kwargs, n_batches=3, graded=False, ignore=False, edits=("edges",)):
    jm = getattr(jr, cls)(**kwargs)
    tm = getattr(tr, cls)(**kwargs, **CPU)
    for b in range(n_batches):
        p, t, i = _data(20 + b, n_queries=4, docs=(2, 15), edits=edits, graded=graded)
        if ignore:
            t[np.random.default_rng(b).uniform(size=t.shape) < 0.2] = -100
        jm.update(*_j(p, t, i))
        tm.update(*_t(p, t, i))
    return jm, tm


@pytest.mark.parametrize("action", ["neg", "pos", "skip"])
@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_classes_update_compute(cls, action):
    jm, tm = _drive(cls, {**CLASSES[cls], "empty_target_action": action}, graded=cls == "RetrievalNormalizedDCG")
    for leaf in ("indexes", "preds", "target"):
        for g, w in zip(tm.metric_state[leaf], jm.metric_state[leaf]):
            assert _np(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    _close(tm.compute(), jm.compute())


@pytest.mark.parametrize("aggregation", ["mean", "median", "min", "max", "callable"])
@pytest.mark.parametrize("cls", ["RetrievalMAP", "RetrievalNormalizedDCG", "RetrievalFallOut"])
def test_classes_aggregation(cls, aggregation):
    agg = {"callable": lambda x, axis=None: (x * x).sum()}.get(aggregation, aggregation)
    jm, tm = _drive(cls, {**CLASSES[cls], "aggregation": agg}, graded=cls == "RetrievalNormalizedDCG")
    _close(tm.compute(), jm.compute())


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_classes_ignore_index_forward_and_state_from_jax(cls):
    kwargs = {**CLASSES[cls], "ignore_index": -100}
    jm, tm = _drive(cls, kwargs, n_batches=2, ignore=True, graded=cls == "RetrievalNormalizedDCG")
    # a JAX state carried in mid-stream, then one more batch through both
    carried = getattr(tr, cls)(**kwargs, **CPU)
    state = {k: ([np.asarray(x) for x in v] if isinstance(v, tuple) else np.asarray(v))
             for k, v in jm.metric_state.items()}
    carried._state = state_from_jax(carried, state)
    p, t, i = _data(40, n_queries=3, docs=(3, 9), edits=("edges",), graded=cls == "RetrievalNormalizedDCG")
    _close(tm(*_t(p, t, i)), jm(*_j(p, t, i)))
    carried.update(*_t(p, t, i))
    _close(tm.compute(), jm.compute())
    _close(carried.compute(), jm.compute())


def test_error_action_and_empty_state():
    jm, tm = _drive("RetrievalMAP", {"empty_target_action": "error"})
    with pytest.raises(ValueError) as want:
        jm.compute()
    with pytest.raises(ValueError) as got:
        tm.compute()
    assert str(got.value) == str(want.value)
    for cls in sorted(CLASSES):
        np.testing.assert_array_equal(_np(getattr(tr, cls)(**CPU).compute()), np.asarray(getattr(jr, cls)().compute()))


@pytest.mark.parametrize("kwargs", [{"max_k": 6}, {"max_k": None}, {"max_k": 30, "adaptive_k": True},
                                    {"max_k": 4, "empty_target_action": "skip"},
                                    {"max_k": 4, "empty_target_action": "pos", "aggregation": "median"}])
def test_precision_recall_curve_class(kwargs):
    jm, tm = _drive("RetrievalPrecisionRecallCurve", kwargs)
    for g, w in zip(tm.compute(), jm.compute()):
        assert _np(g).dtype == np.asarray(w).dtype
        _close(g, w)


@pytest.mark.parametrize("min_precision", [0.0, 0.3, 1.0])
def test_recall_at_fixed_precision_class(min_precision):
    jm, tm = _drive("RetrievalRecallAtFixedPrecision", {"max_k": 8, "min_precision": min_precision})
    for g, w in zip(tm.compute(), jm.compute()):
        assert _np(g).dtype == np.asarray(w).dtype
        _close(g, w)


@pytest.mark.parametrize("top_k", [None, 5])
def test_auroc_class_max_fpr(top_k):
    jm, tm = _drive("RetrievalAUROC", {"max_fpr": 0.5, "top_k": top_k}, edits=())
    _close(tm.compute(), jm.compute(), rtol=1e-5)


@pytest.mark.parametrize("action", ["neg", "pos", "skip", "error"])
def test_auroc_class_max_fpr_with_every_row_ignored(action):
    """Every row dropped by ``ignore_index``: no query to score. JAX's ``neg`` and ``pos`` give the mean
    of nothing (NaN); its ``skip`` and ``error`` raise, and the port raises the same exception types."""
    kwargs = {"max_fpr": 0.5, "ignore_index": -1, "empty_target_action": action}
    jm, tm = jr.RetrievalAUROC(**kwargs), tr.RetrievalAUROC(**kwargs, **CPU)
    p, t, i = np.asarray([0.3, 0.6], F32), np.asarray([-1, -1]), np.asarray([0, 0], np.int32)
    jm.update(*_j(p, t, i))
    tm.update(*_t(p, t, i))
    try:
        want = jm.compute()
    except (IndexError, ValueError) as err:
        with pytest.raises(type(err)):
            tm.compute()
        return
    got = tm.compute()
    assert np.isnan(np.asarray(want)) and _np(got).dtype == np.float32
    _close(got, want)


def test_class_errors_as_jax():
    cases = [
        ("RetrievalMAP", {"empty_target_action": "maybe"}), ("RetrievalMAP", {"ignore_index": 1.5}),
        ("RetrievalMAP", {"aggregation": "mode"}), ("RetrievalMAP", {"top_k": 0}),
        ("RetrievalPrecision", {"adaptive_k": 1}), ("RetrievalAUROC", {"max_fpr": 2.0}),
        ("RetrievalPrecisionRecallCurve", {"max_k": -1}), ("RetrievalRecallAtFixedPrecision", {"min_precision": 2}),
    ]
    for cls, kwargs in cases:
        with pytest.raises(ValueError) as want:
            getattr(jr, cls)(**kwargs)
        with pytest.raises(ValueError) as got:
            getattr(tr, cls)(**kwargs, **CPU)
        assert str(got.value) == str(want.value), (cls, kwargs)
    p, t, i = _data(50, n_queries=2, docs=(4, 4))
    bad = t.copy()
    bad[0] = 3
    for args in ((p, t, None), (p, t[:-1], i), (p, bad, i)):
        jm, tm = jr.RetrievalMAP(), tr.RetrievalMAP(**CPU)
        with pytest.raises(ValueError) as want:
            jm.update(*(None if a is None else jnp.asarray(a) for a in args))
        with pytest.raises(ValueError) as got:
            tm.update(*(None if a is None else torch.from_numpy(a) for a in args))
        assert str(got.value) == str(want.value)


def test_update_reads_the_host_once(monkeypatch):
    reads = []
    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist", lambda self: reads.append(1) or real(self))
    p, t, i = _data(51, n_queries=3, docs=(4, 9))
    t[:3] = -1
    tr.RetrievalMAP(ignore_index=-1, **CPU).update(*_t(p, t, i))
    tr.RetrievalNormalizedDCG(**CPU).update(*_t(p, t, i))
    assert len(reads) == 1


def test_pickle_and_clone():
    _, tm = _drive("RetrievalMAP", {})
    _close(pickle.loads(pickle.dumps(tm)).compute(), tm.compute())
    _close(tm.clone().compute(), tm.compute())


# ----------------------------------------------------------------- the kernel: plan, launcher, model
def test_plan():
    sort_bytes = lambda width, threads: 8 * width + 2 * 4 * 256 * (threads // 32)  # noqa: E731
    count_bytes = (8 + 4 + 12) * krt.MAX_POSITIVES
    assert krt.plan(1) == krt.Plan(32, 32, False, count_bytes)
    assert krt.plan(256) == krt.Plan(32, 256, False, count_bytes)
    assert krt.plan(257) == krt.Plan(64, 512, False, sort_bytes(512, 64))
    assert krt.plan(1000) == krt.Plan(128, 1024, False, sort_bytes(1024, 128))  # MS MARCO's 1,000 candidates
    assert sort_bytes(1024, 128) == 16_384
    assert krt.plan(2048).threads == 256 and krt.plan(2049).threads == 512  # 8 words a thread
    assert krt.plan(16_384) == krt.Plan(1024, 16_384, False, sort_bytes(16_384, 1024))
    assert krt.plan(16_385) == krt.Plan(1024, 16_384, True, sort_bytes(16_384, 1024))  # the long path
    long_bytes = 8 * krt.LONG_TILE + 2 * 4 * 256 * 32 + 4 * 4 * 256 + 4 * 256
    assert long_bytes <= krt.plan(100_000).shared_bytes
    for longest in (1, 31, 33, 256, 257, 1000, 4097, 16_384, 100_000):
        g = krt.plan(longest)
        assert 32 <= g.threads <= 1024 and g.threads % 32 == 0
        for n in (1, longest):  # every query of the launch: a power of two of words a thread, at most 16
            width = max(g.threads, 1 << (n - 1).bit_length())
            items = width // g.threads
            assert items in (1, 2, 4, 8, 16) or (g.long and width > krt.SHARED_WIDTH)
            if items <= 16:  # the sort path's keys, positions and histogram fit the plan's shared memory
                assert sort_bytes(width, g.threads) <= g.shared_bytes
        assert count_bytes <= g.shared_bytes and g.shared_bytes + 4096 <= 227 * 1024


def test_launcher_refuses_what_it_does_not_take():
    p, t = torch.zeros(4), torch.zeros(4)
    off = torch.tensor([0, 4])
    for kwargs, msg in [({"measure": "map"}, "measure"), ({"top_k": 0}, "top_k"),
                        ({"preds": p.double()}, "float32"), ({"offsets": off.int()}, "int64"),
                        ({"target": t[:3]}, "must both be"), ({}, "CUDA tensors only")]:
        args = {"preds": p, "target": t, "offsets": off, "measure": "precision", "longest": 4, **kwargs}
        with pytest.raises(ValueError, match=msg):
            krt.retrieval_groups(**args)


def _order_key(s):
    b = np.where(s == 0, F32(0), s).astype(F32).view(np.uint32).astype(np.uint64)
    return np.where(b & 0x80000000, (~b) & 0xFFFFFFFF, b | 0x80000000)


def _key(s):
    """The kernel's 32-bit key of each score: order-preserving, -0.0 as +0.0, NaN 0."""
    return np.where(np.isnan(s), np.uint64(0), _order_key(s)).astype(np.uint64)


def _words(s):
    """Each document's word: its key above the complement of its position (unique, descending = lexsort)."""
    return (_key(s) << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - np.arange(s.shape[0], dtype=np.uint64))


def _radix_order(s):
    """The sort path's order: a stable LSD radix sort of the complemented keys, 4 passes of 8 bits,
    positions carried as the values (each pass a stable partition by its digit)."""
    dk = (~_key(s)) & np.uint64(0xFFFFFFFF)
    order = np.arange(s.shape[0])
    for shift in (0, 8, 16, 24):
        digit = (dk[order] >> np.uint64(shift)) & np.uint64(0xFF)
        order = order[np.argsort(digit, kind="stable")]
    return order


def _counted(s, x, measure, top_k, n_rel):
    """The counting path: each positive's rank the count of greater words, the measure from the ranks
    (and, for AUROC, the counts of greater and equal keys), sums over the positives in position order."""
    n, w, k = s.shape[0], _words(s), _key(s)
    k_eff = n if top_k is None else min(top_k, n)
    pos = np.flatnonzero(x > 0)
    wp, kp, xp = w[pos], k[pos], x[pos]
    rank = np.array([(w > v).sum() for v in wp], dtype=np.int64)
    in_k = rank < k_eff
    if measure in ("precision", "recall", "hit_rate", "fall_out"):
        a0 = float(np.sum(xp[in_k], dtype=np.float64))
        return a0, k_eff - a0, 0.0, None
    if measure == "average_precision":
        above = np.array([(wp > v).sum() for v in wp], dtype=np.int64)
        terms = (xp * ((above + 1).astype(F32) / (rank + 1).astype(F32))).astype(F32)
        return float(np.sum(terms[in_k], dtype=np.float64)), float(np.sum(xp[in_k], dtype=np.float64)), 0.0, None
    if measure == "reciprocal_rank":
        return 0.0, 0.0, 0.0, int(rank[in_k].min()) if in_k.any() else None
    if measure == "r_precision":
        return float(np.sum(xp[rank.astype(F32) < F32(n_rel)], dtype=np.float64)), 0.0, 0.0, None
    if measure == "ndcg":
        disc = lambda r: (F32(1) / np.log2(r.astype(F32) + F32(2))).astype(F32)  # noqa: E731
        tw = (_key(xp) << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - pos.astype(np.uint64))
        ideal = np.array([(tw > v).sum() for v in tw], dtype=np.int64)
        gain = np.maximum(xp, F32(0))
        dcg = np.sum((gain * disc(rank))[in_k], dtype=np.float64)
        idcg = np.sum((gain * disc(ideal))[ideal < k_eff], dtype=np.float64)
        return float(dcg), float(idcg), 0.0, None
    # auroc: the negatives above each positive's run, and half those of its run inside the top k
    credit = 0.0
    for j in np.flatnonzero(in_k):
        greater = int((wp > wp[j]).sum())
        if kp[j] == 0:
            credit += rank[j] - greater
            continue
        above, equal = int((k > kp[j]).sum()), int((k == kp[j]).sum())
        pos_above = int((kp > kp[j]).sum())
        tied_after_pos = int(((kp == kp[j]) & (wp < wp[j]) & (rank < k_eff)).sum())
        tied_before = (rank[j] - above) - (greater - pos_above)
        tied_after = min(equal - 1 - (rank[j] - above), k_eff - 1 - rank[j]) - tied_after_pos
        credit += (above - pos_above) + 0.5 * (tied_before + tied_after)
    a1 = float(np.sum(xp[in_k], dtype=np.float64))
    return credit, a1, k_eff - a1, None


def _scanned(s, x, measure, top_k, n_rel):
    """The sort path: the radix order, the targets read back by position, one scan in double."""
    n = s.shape[0]
    order = _radix_order(s)
    keys, tt = _key(s)[order], x[order]
    r = np.arange(n)
    in_k = r < (top_k if top_k is not None else n + 1)
    if measure == "average_precision":
        prefix = np.cumsum(tt, dtype=np.float64).astype(F32)
        terms = (tt * (prefix / (r + 1).astype(F32))).astype(F32)
        return float(np.sum(terms[in_k], dtype=np.float64)), float(np.sum(tt[in_k], dtype=np.float64)), 0.0, None
    if measure == "auroc":
        pm, nm = np.where(in_k, tt, 0).astype(np.float64), np.where(in_k, 1 - tt, 0).astype(np.float64)
        starts = np.ones(n, bool)
        starts[1:] = (keys[1:] == 0) | (keys[1:] != keys[:-1])
        ends = np.ones(n, bool)
        ends[:-1] = starts[1:]
        pn, run = np.cumsum(nm), np.cumsum(starts) - 1
        rp, rn = np.bincount(run, pm), np.bincount(run, nm)
        return float(np.sum(rp[run[ends]] * (pn[ends] - 0.5 * rn[run[ends]]))), pm.sum(), nm.sum(), None
    if measure == "ndcg":
        disc = (F32(1) / np.log2(r.astype(F32) + F32(2))).astype(F32)
        ideal = x[_radix_order(x)]
        return (float(np.sum((np.maximum(tt, 0) * disc)[in_k], dtype=np.float64)),
                float(np.sum((np.maximum(ideal, 0) * disc)[in_k], dtype=np.float64)), 0.0, None)
    if measure == "reciprocal_rank":
        hits = r[in_k & (tt > 0)]
        return 0.0, 0.0, 0.0, int(hits[0]) if hits.size else None
    if measure == "r_precision":
        return float(np.sum(tt[r.astype(F32) < F32(n_rel)], dtype=np.float64)), 0.0, 0.0, None
    return float(np.sum(tt[in_k], dtype=np.float64)), float(np.sum(1 - tt[in_k], dtype=np.float64)), 0.0, None


def _kernel_model(p, t, offsets, measure, top_k, adaptive, count_limit=krt.COUNT_SHORT):
    """numpy model of the kernel: each query read once (its target sum, positives and whether every target
    is 0 or 1); a query with at most ``count_limit`` positives (binary targets, or any for NDCG) takes the
    counting path, the rest the radix sort path; the value from the sums with JAX's float32 quotients.
    Returns the scores, the n_rel and each query's path."""
    out, rel_out, paths = [], [], []
    for g in range(len(offsets) - 1):
        s, x = p[offsets[g]:offsets[g + 1]], t[offsets[g]:offsets[g + 1]].astype(F32)
        n = s.shape[0]
        n_rel = float(np.sum(x, dtype=np.float64))
        binary = bool(np.all((x == 0) | (x == 1)))
        n_pos = int((x > 0).sum())
        counting = (measure == "ndcg" or binary) and n_pos <= min(count_limit, krt.MAX_POSITIVES)
        a0, a1, a2, first = (_counted if counting else _scanned)(s, x, measure, top_k, n_rel)
        rel, size = F32(n_rel), F32(n)
        div = lambda num, den: F32(num) / F32(den) if F32(den) != 0 else F32(0)  # noqa: E731
        if measure == "precision":
            value = div(a0, size if top_k is None else (min(F32(top_k), size) if adaptive else F32(top_k)))
        elif measure in ("recall", "r_precision"):
            value = div(a0, rel)
        elif measure == "hit_rate":
            value = F32(F32(a0) > 0)
        elif measure == "fall_out":
            value = div(a1, size - rel)
        elif measure in ("average_precision", "ndcg"):
            value = div(a0, a1)
        elif measure == "reciprocal_rank":
            value = F32(1) / (F32(first) + F32(1)) if first is not None else F32(0)
        else:  # auroc
            value = div(F32(a1 * a2 - a0), F32(a1) * F32(a2))
        out.append(F32(value))
        rel_out.append(rel)
        paths.append("counting" if counting else "sort")
    return np.asarray(out, F32), np.asarray(rel_out, F32), paths


def _layout(p, t, i):
    order = np.argsort(i, kind="stable")
    _, counts = np.unique(i[order], return_counts=True)
    return p[order], t[order], np.concatenate([[0], np.cumsum(counts)])


MODEL_MEASURES = ["precision", "recall", "hit_rate", "fall_out", "average_precision", "reciprocal_rank",
                  "r_precision", "ndcg", "auroc"]


@pytest.mark.parametrize("top_k,adaptive", [(None, False), (3, False), (3, True)])
@pytest.mark.parametrize("measure", MODEL_MEASURES)
def test_kernel_model_against_jax(measure, top_k, adaptive):
    """The kernel's algorithm (counting or radix sort, the kernel's threshold) equals the JAX grouped
    measure on ties, NaN, +-inf and +-0.0 scores, with the query ids' stable sort as glue."""
    p, t, i = _data(60, n_queries=8, docs=(1, 40), edits=("edges",), graded=measure == "ndcg")
    got = _kernel_model(*_layout(p, t, i), measure, top_k, adaptive)
    want = _jax_scores(p, t, i, measure, top_k, adaptive)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("top_k", [None, 2, 17, 60])
@pytest.mark.parametrize("measure", MODEL_MEASURES)
@pytest.mark.parametrize("side", ["every query counted", "every query sorted", "at the threshold"])
def test_kernel_model_paths_against_jax(side, measure, top_k):
    """Both paths and the threshold between them, against JAX: queries of 1 to 80 documents with 0 to
    all of them relevant (ties, NaN, +-inf, +-0.0; graded targets for NDCG), each taken by counting, by
    the radix sort, or by the launcher's rule with a threshold of 6 positives that splits the batch."""
    rng = np.random.default_rng(61)
    p, t, i = _data(62, n_queries=14, docs=(1, 80), edits=("edges",), graded=measure == "ndcg")
    share = rng.uniform(0.0, 0.3, 200)[np.abs(i) % 200]  # each query its own share of relevant documents
    if measure != "ndcg":
        t = np.where(rng.uniform(size=t.shape) < share, 1, 0)
    limit = {"every query counted": krt.MAX_POSITIVES, "every query sorted": -1, "at the threshold": 6}[side]
    got_s, got_rel, paths = _kernel_model(*_layout(p, t, i), measure, top_k, False, count_limit=limit)
    want = _jax_scores(p, t, i, measure, top_k, False)
    _close(got_s, want[0])
    np.testing.assert_array_equal(got_rel, np.asarray(want[1]))
    if side == "at the threshold":
        assert {"counting", "sort"} <= set(paths), paths


@pytest.mark.parametrize("edits", [(), ("edges",)])
def test_radix_order_is_the_stable_descending_order(edits):
    """Four stable 8-bit passes over the complemented keys give the words' descending order: jnp.lexsort's."""
    p, _, _ = _data(63, n_queries=1, docs=(300, 300), edits=edits)
    np.testing.assert_array_equal(_radix_order(p), np.argsort(_words(p))[::-1])
