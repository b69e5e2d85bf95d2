"""The port's sketch primitives (``torchmetrics_tpu_torch.sketches``) against the JAX package's.

The same seeded numpy inputs go through both packages on the CPU.

Tolerances: ``mix32``, HyperLogLog registers, count-min tables and queries,
quantile histograms and cell indices, and reservoir rows are equal bit for
bit; ``estimate``, ``query``, ``cdf``, ``curve_confmat`` and
``auc_error_bound`` are within 1e-6 relative (float32 sums in another order
than XLA's; ``query`` returns grid edges, equal). The grid's edges are JAX's
bit for bit on ``[0, 1]`` and within ``2**-23 * (hi - lo)`` elsewhere.

It also holds numpy models of the two hand kernels' algorithms against the
plain versions and JAX: ``quantile_hist`` (the launcher's plan, int32 counts
a block, each non-zero count added into the float32 state in any order) and
``hll_insert`` (the uint32 key chain a window, ``clz`` of the rest, the
maximum a register, the count of valid windows added once): change the
models with the kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu import sketches as J
from torchmetrics_tpu.text import DistinctNGrams as JDistinct
from torchmetrics_tpu_torch import sketches as T
from torchmetrics_tpu_torch.core.reductions import SketchReduce, canonical_reduce, merge_leaf, reduce_identity
from torchmetrics_tpu_torch.kernels import hll as khll
from torchmetrics_tpu_torch.kernels import quantile_hist as kqh
from torchmetrics_tpu_torch.sketches.quantile import _linspace32

RTOL = 1e-6

#: the edge inputs of a score histogram: NaN, +-inf, -0.0, 1.0, a value one ulp either side of a cell edge
EDGE_VALUES = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, 0.99999994, 0.005, np.nextafter(0.005, 0),
                        np.nextafter(0.005, 1), 0.015, np.nextafter(0.015, 0), 0.5, np.nextafter(0.5, 0), 1.5, -0.5],
                       np.float32)


def _u32(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(x):
    """A numpy array as a torch CPU tensor (uint32 as int64, the port's hash type)."""
    return torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32 else x)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------- mix32
@pytest.mark.parametrize("salt", [0, 1, 0x1B873593, 0x9E3779B9, 0xFFFFFFFF])
def test_mix32_is_jax_bit_for_bit(salt):
    rng = np.random.default_rng(salt % 1000)
    x = np.concatenate([_u32(rng, 20_000), np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)])
    want = _np(J.mix32(jnp.asarray(x), salt)).astype(np.int64)
    got = T.mix32(_t(x), salt)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)


def test_mix32_wraps_signed_keys_and_tensor_salts():
    """An int32 key wraps to its uint32 bits; a salt tensor broadcasts, as count-min's salts a row do."""
    keys = np.array([-1, -2**31, 0, 5, 2**31 - 1], np.int32)
    salts = np.array([[0], [0x7FEB352D], [0xFFFFFFFF]], np.uint32)
    want = _np(J.mix32(jnp.asarray(keys)[None, :], jnp.asarray(salts))).astype(np.int64)
    assert np.array_equal(T.mix32(torch.from_numpy(keys)[None, :], _t(salts)).numpy(), want)


# ---------------------------------------------------------------- HyperLogLog
@pytest.mark.parametrize("precision", [4, 11, 14, 18])
def test_hll_registers_bit_for_bit_and_estimate(precision):
    rng = np.random.default_rng(precision)
    hj, ht = J.HyperLogLog(precision=precision), T.HyperLogLog(precision=precision)
    regs_j, regs_t = hj.init(), ht.init()
    for n in (0, 1, 5_000, 40_000):  # a zero-length batch first
        keys = rng.integers(-2**31, 2**31, n).astype(np.int32)
        mask = rng.random(n) > 0.2
        regs_j = hj.insert_batch(regs_j, jnp.asarray(keys), jnp.asarray(mask))
        regs_t = ht.insert_batch(regs_t, torch.from_numpy(keys), torch.from_numpy(mask))
        assert regs_t.dtype == torch.int32 and np.array_equal(regs_t.numpy(), _np(regs_j))
    np.testing.assert_allclose(float(ht.estimate(regs_t)), float(hj.estimate(regs_j)), rtol=RTOL)
    assert ht.relative_error == hj.relative_error and ht.m == hj.m


@pytest.mark.parametrize("precision", [4, 8, 11])
def test_hll_estimate_small_range_and_empty(precision):
    """The linear-counting branch (few keys) and the empty registers, within 1e-6 relative."""
    hj, ht = J.HyperLogLog(precision=precision), T.HyperLogLog(precision=precision)
    for n in (0, 3, 40, 400):
        keys = np.arange(n, dtype=np.int32) * 7919
        rj = hj.insert_batch(hj.init(), jnp.asarray(keys))
        rt = ht.insert_batch(ht.init(), torch.from_numpy(keys))
        np.testing.assert_allclose(float(ht.estimate(rt)), float(hj.estimate(rj)), rtol=RTOL)


def test_hll_ctor_sizing_merge_and_spec():
    for eps in (None, 0.5, 0.05, 0.01, 0.002):
        assert T.HyperLogLog.for_error(eps).precision == J.HyperLogLog.for_error(eps).precision
    for p in (3, 19):
        with pytest.raises(ValueError, match="precision"):
            T.HyperLogLog(precision=p)
    ht = T.HyperLogLog(precision=6)
    a, b = torch.tensor(np.arange(64) % 7, dtype=torch.int32), torch.tensor(np.arange(64) % 5, dtype=torch.int32)
    assert torch.equal(ht.merge(a, b), torch.maximum(a, b))
    assert ht.reduce_spec == SketchReduce(kind="hll", bucket_op="max")


# ---------------------------------------------------------------- count-min
@pytest.mark.parametrize(("width", "depth"), [(1, 1), (97, 4), (1000, 5)])
def test_countmin_tables_and_queries_equal(width, depth):
    rng = np.random.default_rng(width)
    cj, ct = J.CountMinSketch(width=width, depth=depth), T.CountMinSketch(width=width, depth=depth)
    tj, tt = cj.init(), ct.init()
    for n, weighted in ((0, False), (3_000, False), (2_000, True)):
        keys = rng.integers(-50, 500, n).astype(np.int32)
        w = np.round(rng.random(n) * 8).astype(np.float32) if weighted else None
        tj = cj.insert_batch(tj, jnp.asarray(keys), None if w is None else jnp.asarray(w))
        tt = ct.insert_batch(tt, torch.from_numpy(keys), None if w is None else torch.from_numpy(w))
        assert np.array_equal(tt.numpy(), _np(tj))
    q = np.arange(-60, 520, 3).astype(np.int32)
    assert np.array_equal(ct.query(tt, torch.from_numpy(q)).numpy(), _np(cj.query(tj, jnp.asarray(q))))
    assert ct.overcount_fraction == cj.overcount_fraction
    for eps, delta in ((0.01, 0.01), (0.2, 0.5)):
        f_j, f_t = J.CountMinSketch.for_error(eps, delta), T.CountMinSketch.for_error(eps, delta)
        assert (f_t.width, f_t.depth) == (f_j.width, f_j.depth)


# ---------------------------------------------------------------- quantile sketch
@pytest.mark.parametrize("bins", [2, 7, 200, 1000])
def test_cell_index_and_edges_are_jax(bins):
    sj, st = J.QuantileSketch(bins), T.QuantileSketch(bins)
    v = np.concatenate([EDGE_VALUES, _np(sj.edges), np.nextafter(_np(sj.edges), np.float32(2))]).astype(np.float32)
    assert np.array_equal(st.cell_index(torch.from_numpy(v)).numpy(), _np(sj.cell_index(jnp.asarray(v))))
    assert np.array_equal(st.edges.numpy(), _np(sj.edges))


def test_nan_lands_in_cell_zero():
    """JAX's cast of a NaN cell on the CPU gives 0: the port replaces the NaN before its cast."""
    st = T.QuantileSketch(200)
    got = st.cell_index(torch.tensor([float("nan"), float("inf"), float("-inf"), 1.0, 0.99999994, 0.005, 0.015,
                                      -0.0]))
    assert got.tolist() == [0, 200, 0, 200, 199, 1, 3, 0]


@pytest.mark.parametrize(("lo", "hi", "num"), [(-2.0, 3.0, 8), (-1.0, 1.0, 334), (0.1, 0.7, 201), (-5.0, 5.0, 1001)])
def test_edges_on_other_ranges_within_an_ulp_of_the_range(lo, hi, num):
    want = _np(jnp.linspace(lo, hi, num, dtype=jnp.float32))
    got = _linspace32(lo, hi, num)
    assert got[0] == want[0] and got[-1] == want[-1]
    assert np.abs(got - want).max() <= 2.0**-23 * (hi - lo)


@pytest.mark.parametrize("prefix", [(), (3,), (4, 2)])
def test_histograms_equal_on_edge_inputs(prefix):
    rng = np.random.default_rng(len(prefix))
    sj, st = J.QuantileSketch(200), T.QuantileSketch(200)
    hj, ht = sj.init(prefix), st.init(prefix)
    for n in (0, 16, 500):
        values = rng.random((n, *prefix)).astype(np.float32)
        flat = values.reshape(-1)
        flat[: min(len(flat), len(EDGE_VALUES))] = EDGE_VALUES[: len(flat)]
        weights = (rng.random((n, *prefix)) > 0.3).astype(np.float32)
        hj = sj.insert_batch(hj, jnp.asarray(values), jnp.asarray(weights))
        ht = st.insert_batch(ht, torch.from_numpy(values), torch.from_numpy(weights))
        assert np.array_equal(ht.numpy(), _np(hj))
    hj = sj.insert_batch(hj, jnp.asarray(values))  # weights omitted: ones
    ht = st.insert_batch(ht, torch.from_numpy(values))
    assert np.array_equal(ht.numpy(), _np(hj))


def _curve_hist(rng, prefix, n=3_000, bins=200):
    """A (neg, pos) curve histogram pair of ``prefix`` rows from the JAX sketch, as numpy."""
    sj = J.QuantileSketch(bins)
    t = (rng.random((n, *prefix)) < 0.4)
    p = np.clip(rng.normal(0.35 + 0.3 * t, 0.25), 0, 1).astype(np.float32)
    values = np.broadcast_to(p[..., None], (*p.shape, 2))
    w = np.stack([~t, t], axis=-1).astype(np.float32)
    return _np(sj.insert_batch(sj.init((*prefix, 2)), jnp.asarray(values), jnp.asarray(w)))


@pytest.mark.parametrize("prefix", [(), (5,)])
def test_curve_queries_within_1e6(prefix):
    rng = np.random.default_rng(7)
    sj, st = J.QuantileSketch(200), T.QuantileSketch(200)
    hist = _curve_hist(rng, prefix).copy()
    hj, ht = jnp.asarray(hist), torch.from_numpy(hist)
    np.testing.assert_allclose(st.curve_confmat(ht).numpy(), _np(sj.curve_confmat(hj)), rtol=RTOL)
    np.testing.assert_allclose(st.auc_error_bound(ht).numpy(), _np(sj.auc_error_bound(hj)), rtol=RTOL)
    np.testing.assert_allclose(st.tail_counts(ht).numpy(), _np(sj.tail_counts(hj)), rtol=RTOL)
    np.testing.assert_allclose(st.total(ht).numpy(), _np(sj.total(hj)), rtol=RTOL)
    x = np.array([0.0, 0.1, 0.37, 0.5, 0.99, 1.0], np.float32).reshape(-1, *([1] * (len(prefix) + 1)))
    x = np.broadcast_to(x, (6, *prefix, 2)).copy()
    for xi in x:
        np.testing.assert_allclose(st.cdf(ht, torch.from_numpy(xi)).numpy(), _np(sj.cdf(hj, jnp.asarray(xi))),
                                   rtol=RTOL)
    for q in (0.0, 0.1, 0.5, 0.9, 1.0):
        np.testing.assert_allclose(st.query(ht, q).numpy(), _np(sj.query(hj, q)), rtol=RTOL)
    q_rows = np.linspace(0.05, 0.95, int(np.prod((*prefix, 2)))).astype(np.float32).reshape(*prefix, 2)
    np.testing.assert_allclose(st.query(ht, torch.from_numpy(q_rows)).numpy(), _np(sj.query(hj, jnp.asarray(q_rows))),
                               rtol=RTOL)
    prov_j, prov_t = sj.provenance(hj), st.provenance(ht)
    assert set(prov_t) == set(prov_j)
    for key, value in prov_j.items():
        np.testing.assert_allclose(prov_t[key], value, rtol=RTOL) if isinstance(value, float) else None
    assert st.provenance(torch.zeros(3)) == {k: v for k, v in sj.provenance().items()}


def test_quantile_ctor_and_sizing():
    for eps in (None, 0.5, 0.01, 1 / 200, 0.003):
        assert T.QuantileSketch.for_error(eps).bins == J.QuantileSketch.for_error(eps).bins
    assert T.bins_for_error(0.3, -1.0, 1.0) == J.bins_for_error(0.3, -1.0, 1.0)
    with pytest.raises(ValueError, match="approx_error"):
        T.bins_for_error(0.0)
    with pytest.raises(ValueError, match="bins"):
        T.QuantileSketch(1)
    with pytest.raises(ValueError, match="hi > lo"):
        T.QuantileSketch(4, lo=1.0, hi=1.0)
    assert T.DEFAULT_APPROX_ERROR == J.DEFAULT_APPROX_ERROR
    assert T.QuantileSketch(10).reduce_spec.bucket_op == "sum"


# ---------------------------------------------------------------- reservoir
def _records(rng, n, fields):
    return rng.random((n, fields)).astype(np.float32)


@pytest.mark.parametrize(("capacity", "fields"), [(1, 1), (16, 3), (64, 10)])
def test_reservoir_rows_equal_with_duplicate_keys(capacity, fields):
    rng = np.random.default_rng(capacity)
    rj, rt = J.ReservoirSketch(capacity, fields), T.ReservoirSketch(capacity, fields)
    sj, st = rj.init(), rt.init()
    assert np.array_equal(st.numpy(), _np(sj))
    for n in (0, 5, 40, 3):
        keys = _u32(rng, n)
        keys[: n // 3] = keys[0] if n else keys[: n // 3]  # duplicate keys: equal priorities, ordered by position
        rec = _records(rng, n, fields)
        sj = rj.insert_batch(sj, jnp.asarray(rec), jnp.asarray(keys))
        st = rt.insert_batch(st, torch.from_numpy(rec), _t(keys))
        assert np.array_equal(st.numpy(), _np(sj))
    assert int(rt.count(st)) == int(rj.count(sj))
    assert np.array_equal(rt.valid_mask(st).numpy(), _np(rj.valid_mask(sj)))
    np.testing.assert_allclose(float(rt.scale_factor(st, torch.tensor(500))), float(rj.scale_factor(sj, jnp.asarray(500))),
                               rtol=RTOL)


@pytest.mark.parametrize("stacked", [1, 2, 3, 4])
def test_reservoir_combine_stacked_equal(stacked):
    rng = np.random.default_rng(100 + stacked)
    rj, rt = J.ReservoirSketch(24, 2), T.ReservoirSketch(24, 2)
    parts_j, parts_t = [], []
    for i in range(stacked):
        keys = _u32(rng, 10 * (i + 1))
        if i:  # a key another reservoir holds too
            keys[0] = 12345
        rec = _records(rng, len(keys), 2)
        parts_j.append(rj.insert_batch(rj.init(), jnp.asarray(rec), jnp.asarray(keys)))
        parts_t.append(rt.insert_batch(rt.init(), torch.from_numpy(rec), _t(keys)))
    got = rt.combine_stacked(torch.stack(parts_t)).numpy()
    assert np.array_equal(got, _np(rj.combine_stacked(jnp.stack(parts_j))))
    if stacked == 2:
        assert np.array_equal(rt.merge(*parts_t).numpy(), _np(rj.merge(*parts_j)))


def test_reservoir_priority_and_ctor():
    keys = np.array([0, 1, 0xFFFFFFFF, 0xFFFFFFFE, 2**31], np.uint32)
    rj, rt = J.ReservoirSketch(4, 1), T.ReservoirSketch(4, 1)
    assert np.array_equal(rt.priority(_t(keys)).numpy(), _np(rj.priority(jnp.asarray(keys))))
    assert T.EMPTY_PRIORITY == J.EMPTY_PRIORITY
    spec = rt.reduce_spec
    assert spec.bucket_op is None and spec.n_sync_gathers == 1
    for bad in ((0, 1), (1, 0)):
        with pytest.raises(ValueError):
            T.ReservoirSketch(*bad)


# ---------------------------------------------------------------- reductions
def test_sketch_reduce_spec_and_reductions():
    with pytest.raises(ValueError, match="bucket_op"):
        SketchReduce(kind="x", bucket_op="mean")
    with pytest.raises(ValueError, match="combine_stacked"):
        SketchReduce(kind="x")
    with pytest.raises(ValueError, match="marker"):
        canonical_reduce("sketch")
    spec = SketchReduce(kind="quantile", bucket_op="sum")
    assert canonical_reduce(spec) is spec and T.is_sketch_reduce(spec) and not T.is_sketch_reduce("sum")
    a, b = torch.tensor([1.0, 5.0]), torch.tensor([3.0, 2.0])
    assert torch.equal(merge_leaf(spec, a, b), a + b)
    assert torch.equal(merge_leaf(SketchReduce("hll", "max"), a, b), torch.tensor([3.0, 5.0]))
    assert torch.equal(merge_leaf(SketchReduce("m", "min"), a, b), torch.tensor([1.0, 2.0]))
    res = T.ReservoirSketch(2, 1)
    assert torch.equal(merge_leaf(res.reduce_spec, res.init(), res.init()), res.init())
    assert float(reduce_identity(spec, torch.float32)) == 0.0
    assert int(reduce_identity(SketchReduce("hll", "max"), torch.int32)) == torch.iinfo(torch.int32).min
    assert reduce_identity(res.reduce_spec, torch.float32) is None


# ---------------------------------------------------------------- quantile_hist: plain and the kernel's model
def _curve_inputs(rng, n, k, task, edges=True):
    """A formatted batch of the curve family: float32 scores, int32 targets, 0/1 float32 weights."""
    shape = (n,) if task == "binary" else (n, k)
    scores = rng.random(shape).astype(np.float32)
    if edges and scores.size:
        flat = scores.reshape(-1)
        flat[: min(flat.size, len(EDGE_VALUES))] = EDGE_VALUES[: flat.size]
    if task == "multiclass":
        target = rng.integers(-1, k + 1, n).astype(np.int32)  # a target outside [0, k) is a negative everywhere
        weights = (rng.random(n) > 0.2).astype(np.float32)
    else:
        target = (rng.random(shape) < 0.4).astype(np.int32)
        weights = (rng.random(shape) > 0.2).astype(np.float32)
    return scores, target, weights


def _jax_sketch_insert(hist, p, t, w, sketch):
    """JAX's ``_CurveBase._sketch_insert`` on numpy inputs."""
    import jax

    p, t, w = jnp.asarray(p), jnp.asarray(t), jnp.asarray(w)
    if p.ndim == 2 and t.ndim == 1:
        t = jax.nn.one_hot(t, p.shape[1], dtype=p.dtype)
        w = w[:, None]
    pos = t.astype(p.dtype) * w
    values = jnp.broadcast_to(p[..., None], (*p.shape, 2))
    return _np(sketch.insert_batch(jnp.asarray(hist), values, jnp.stack([w - pos, pos], axis=-1)))


def _quantile_hist_model(hist, scores, target, weights, sketch, sm_count=132):
    """The kernel's algorithm: the plan's blocks, int32 counts a block over its classes and rows, each non-zero
    count added into the float32 state (shuffled: the atomics' order is free)."""
    multiclass = scores.ndim == 2 and target.ndim == 1
    n = scores.shape[0]
    k = scores.shape[1] if scores.ndim == 2 else 1
    s2 = scores.reshape(n, k)
    cells = sketch.bins + 1
    out = hist.reshape(k, 2, cells).copy()
    if n == 0:
        return out.reshape(hist.shape)
    plan = kqh.plan(n, k, cells, sm_count)
    adds = []
    scale = np.float32(sketch.scale)
    for c0 in range(0, k, plan.slice):
        kc = min(plan.slice, k - c0)
        for r0 in range(0, n, plan.rows_per_chunk):
            counts = np.zeros((kc, 2, cells), np.int64)
            for r in range(r0, min(n, r0 + plan.rows_per_chunk)):
                for j in range(kc):
                    c = c0 + j
                    w = weights[r] if multiclass else weights.reshape(n, k)[r, c]
                    if w == 0:
                        continue
                    f = np.floor((np.float32(s2[r, c]) - np.float32(sketch.lo)) * scale)
                    cell = sketch.bins if f >= sketch.bins else (int(f) if f > 0 else 0)
                    if multiclass:
                        counts[j, int(target[r] == c), cell] += 1
                    else:
                        t = int(target.reshape(n, k)[r, c])
                        counts[j, 0, cell] += 1 - t
                        counts[j, 1, cell] += t
            assert np.abs(counts).max(initial=0) < 2**31  # int32 in shared memory
            for idx in zip(*np.nonzero(counts)):
                adds.append(((c0 + idx[0], idx[1], idx[2]), np.float32(counts[idx])))
    for i in np.random.default_rng(0).permutation(len(adds)):
        at, v = adds[i]
        out[at] = np.float32(out[at] + v)
    return out.reshape(hist.shape)


@pytest.mark.parametrize(("task", "n", "k"), [("binary", 257, 1), ("multiclass", 300, 7), ("multiclass", 64, 1000),
                                              ("multilabel", 129, 5), ("binary", 0, 1), ("multilabel", 50, 80)])
def test_quantile_hist_plain_and_model_equal_jax(task, n, k):
    rng = np.random.default_rng(n + k)
    sketch_t, sketch_j = T.QuantileSketch(200), J.QuantileSketch(200)
    shape = (2, 201) if task == "binary" else (k, 2, 201)
    hist = np.round(rng.random(shape) * 5).astype(np.float32)  # a non-zero state
    scores, target, weights = _curve_inputs(rng, n, k, task)
    want = _jax_sketch_insert(hist, scores, target, weights, sketch_j)
    plain = kqh._quantile_hist_plain(torch.from_numpy(hist), torch.from_numpy(scores), torch.from_numpy(target),
                                     torch.from_numpy(weights), sketch_t)
    assert np.array_equal(plain.numpy(), want)
    assert np.array_equal(_quantile_hist_model(hist, scores, target, weights, sketch_t), want)


@pytest.mark.parametrize(("n", "k", "cells"), [(1024, 1000, 201), (256, 80, 201), (1024, 1, 201), (50_000, 1, 201),
                                               (40_504, 80, 201), (7, 3, 7000), (1, 1, 3), (10**6, 1000, 2)])
def test_quantile_hist_plan_covers_every_entry(n, k, cells):
    plan = kqh.plan(n, k, cells, 132)
    assert plan.rows_per_chunk * plan.chunks >= n > plan.rows_per_chunk * (plan.chunks - 1)
    assert 1 <= plan.chunks <= kqh.MAX_CHUNKS and 1 <= plan.slice <= k
    assert plan.rows_per_chunk * plan.slice <= kqh.MAX_ENTRIES
    assert plan.shared == (8 * cells <= kqh.SHARED_BYTES)
    if plan.shared:
        assert plan.slice * 2 * cells * 4 <= kqh.SHARED_BYTES


def test_quantile_hist_refuses_cpu_and_bad_tensors():
    sketch = T.QuantileSketch(10)
    hist, p = torch.zeros((3, 2, 11)), torch.rand(4, 3)
    t, w = torch.zeros(4, dtype=torch.int32), torch.ones(4)
    with pytest.raises(ValueError, match="CUDA"):
        kqh.quantile_hist(hist, p, t, w, sketch)
    with pytest.raises(ValueError, match="shape"):
        kqh.quantile_hist(torch.zeros((3, 2, 12)), p, t, w, sketch)
    with pytest.raises(ValueError, match="dtype"):
        kqh.quantile_hist(hist, p, t.long(), w, sketch)


# ---------------------------------------------------------------- hll_insert: plain and the kernel's model
def _mix32_np(x, salt):
    x = (x ^ np.uint32(salt)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
    x ^= x >> np.uint32(13)
    x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    return x


def _hll_model(registers, total, tokens, ngram, ignore_index, hll):
    """The kernel's algorithm: a window's uint32 key chain and validity, the hash's register and clz rank, the
    maximum a register in any order, the count of valid windows rounded to float32 and added once."""
    regs = registers.copy()
    b, length = tokens.shape
    span = length - ngram + 1
    valid_count = 0
    with np.errstate(over="ignore"):
        for w in np.random.default_rng(1).permutation(max(b * span, 0)):
            row, s = divmod(int(w), span)
            h = np.uint32(0)
            keep = True
            for k in range(ngram):
                t = int(tokens[row, s + k])
                keep = keep and not (ignore_index is not None and t == ignore_index)
                h = _mix32_np(np.array([np.uint32(t & 0xFFFFFFFF) + h], np.uint32),
                              (0x9E3779B9 * (k + 1)) & 0xFFFFFFFF)[0]
            if not keep:
                continue
            valid_count += 1
            x = int(_mix32_np(np.array([h], np.uint32), hll.seed)[0])
            idx = x >> (32 - hll.precision)
            rest = (x << hll.precision) & 0xFFFFFFFF
            rank = 33 - hll.precision if rest == 0 else 32 - rest.bit_length() + 1
            regs[idx] = max(regs[idx], rank)
    return regs, np.float32(np.float32(total) + np.float32(valid_count))


def _jax_distinct_state(tokens, ngram, ignore_index, precision):
    jm = JDistinct(ngram=ngram, ignore_index=ignore_index, approx="sketch", approx_error=1.04 / 2 ** (precision / 2))
    assert jm._hll.precision == precision
    state = jm.update_state(jm.init_state(), jnp.asarray(tokens))
    return _np(state["registers"]), float(state["total"])


@pytest.mark.parametrize(("shape", "ngram", "ignore_index", "precision"), [
    ((8, 64), 1, None, 11), ((8, 64), 2, -100, 11), ((3, 40), 3, 0, 4), ((4, 50), 4, 7, 14), ((2, 33), 2, None, 18),
])
def test_hll_insert_plain_and_model_equal_jax(shape, ngram, ignore_index, precision):
    rng = np.random.default_rng(sum(shape) + ngram)
    tokens = rng.integers(0, 50, shape).astype(np.int32)
    if ignore_index is not None:
        tokens[rng.random(shape) < 0.1] = ignore_index
    tokens[0, :3] = [-1, 2**31 - 1, -2**31]  # ids that wrap to their uint32 bits
    hll = T.HyperLogLog(precision=precision)
    want_regs, want_total = _jax_distinct_state(tokens, ngram, ignore_index, precision)
    regs, total = khll._hll_insert_plain(hll.init(), torch.zeros(()), torch.from_numpy(tokens), ngram, ignore_index,
                                         hll)
    assert np.array_equal(regs.numpy(), want_regs) and float(total) == want_total
    m_regs, m_total = _hll_model(np.zeros(hll.m, np.int32), 0.0, tokens, ngram, ignore_index, hll)
    assert np.array_equal(m_regs, want_regs) and float(m_total) == want_total


def test_hll_insert_no_windows_and_launch_geometry():
    hll = T.HyperLogLog(precision=11)
    regs, total = khll._hll_insert_plain(hll.init(), torch.tensor(3.0), torch.zeros((2, 3), dtype=torch.int32), 4,
                                         None, hll)
    assert int(regs.sum()) == 0 and float(total) == 3.0  # n longer than a row: no windows
    for n_windows, p in ((8_184, 11), (8_184, 14), (1, 4), (10**7, 18), (10**7, 11)):
        blocks = khll.blocks_for(n_windows, p, 132)
        assert 1 <= blocks <= khll.BLOCKS_PER_SM * 132
        per_block = max(khll.THREADS * khll.MIN_WINDOWS_PER_THREAD, (1 << p) if p <= khll.SHARED_PRECISION else 0)
        assert blocks == min(max(1, -(-n_windows // per_block)), khll.BLOCKS_PER_SM * 132)
    with pytest.raises(ValueError, match="CUDA"):
        khll.hll_insert(hll.init(), torch.zeros(()), torch.zeros((2, 5), dtype=torch.int32), 2, None, hll)
