"""The port's fused binned-curve state update against the JAX package.

``_binned_confmat_multiclass_accumulate`` (old int32 state + one formatted
batch -> new state) runs its plain PyTorch version here, on the CPU; on the
card ``chip_smoke.py`` holds the CUDA kernel equal to that plain version.
The kernel's algorithm (bin each score once among the sorted thresholds by
binary lifting, int32 histograms split into bin ranges as the launcher's plan
says, suffix sums, a scatter back to the caller's threshold order) is also
emulated here in numpy, step for step, and held against the JAX function.

Every comparison of counts and states is exact: the counts are sums of 0/1
weights and the states int32.
"""

import importlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu_torch.functional.classification import precision_recall_curve as tprc
from torchmetrics_tpu_torch.kernels import binned_confmat as kbc
from torchmetrics_tpu_torch.kernels.binned_confmat import binned_confmat_multiclass

jprc = importlib.import_module("torchmetrics_tpu.functional.classification.precision_recall_curve")

C = 11
H100_SMS = 132
NAN, INF = float("nan"), float("inf")


def _scores(rng, n, num_classes=C):
    x = rng.normal(size=(n, num_classes)).astype(np.float32)
    return (np.exp(x) / np.exp(x).sum(1, keepdims=True)).astype(np.float32)


def _thresholds(spec):
    if isinstance(spec, int):
        return tprc._linspace_grid(spec)
    return np.asarray(spec, dtype=np.float32)


# (thresholds, rows, share of ignored rows, edits of the formatted batch); see _case
CASES = {
    "grid20": (20, 96, 0.0, ()),
    "grid200": (200, 96, 0.0, ()),
    "unsorted_duplicates": ([0.5, 0.05, 0.95, 0.2, 0.5, 0.0, 1.0, 0.05, 0.75, 0.6], 96, 0.0, ()),
    "nan_and_inf_thresholds": ([0.5, NAN, 0.1, INF, -INF, 0.1, NAN, 0.0, -0.0, 1.0, 0.9], 96, 0.0, ()),
    "nan_and_inf_scores": ([-INF, 0.0, 0.25, 0.5, 1.0, INF, NAN], 96, 0.0, ("nonfinite_scores",)),
    "scores_on_thresholds": (20, 96, 0.0, ("on_grid",)),
    "ignored_rows": (20, 96, 0.15, ()),
    "out_of_range_targets": (20, 96, 0.1, ("out_of_range",)),
    "ragged_last_batch": (20, 848, 0.0, ()),
    "single_threshold": ([0.3], 40, 0.0, ()),
    "overflowing_range": ([0.5, -3e38, 0.1, 3e38, 0.2, 0.2, 0.9, INF], 96, 0.0, ("on_grid",)),
    # thresholds among the smallest normal floats, with both signed zeros
    "vanishing_range": ([1.5e-38, 0.0, 1.5e-38, -0.0, 1.2e-38], 96, 0.0, ("on_grid",)),
    "fine_list_1000": (1000, 64, 0.05, ("on_grid",)),
}


def _case(name, seed=0):
    """Formatted numpy batch ``(p, target, w, thresholds)`` and a non-zero int32 start state."""
    spec, n, ignored, edits = CASES[name]
    rng = np.random.default_rng(seed + len(name))
    thr = _thresholds(spec)
    p = _scores(rng, n)
    target = rng.integers(0, C, size=n).astype(np.int32)
    w = (rng.random(n) >= ignored).astype(np.float32)
    target[w == 0] = 0  # as _multiclass_prc_format leaves an ignored row
    if "on_grid" in edits:  # scores exactly on thresholds, where >= decides the bin
        p[::3, 1] = thr[rng.integers(0, len(thr), size=len(p[::3]))]
        p[np.arange(0, n, 4), target[::4]] = thr[rng.integers(0, len(thr), size=len(target[::4]))]
    if "nonfinite_scores" in edits:
        for i, v in enumerate([NAN, INF, -INF, NAN]):
            p[i::9, (i * 3) % C] = v
            p[i + 4 :: 11, target[i + 4 :: 11]] = v  # on the true class too
    if "out_of_range" in edits:
        for i, v in enumerate([C, C + 3, -3, -1]):
            target[i::8] = v
    state = rng.integers(-(2**20), 2**20, size=(len(thr), C, 2, 2)).astype(np.int32)
    return p, target, w, thr, state


def _jax_new_state(state, p, target, w, thr):
    counts = jprc._binned_confmat_multiclass(jnp.asarray(p), jnp.asarray(target), jnp.asarray(w), jnp.asarray(thr), C)
    return np.asarray(jnp.asarray(state) + counts.astype(jnp.int32))


@pytest.mark.parametrize("name", list(CASES))
def test_accumulate_plain_matches_jax(name):
    p, target, w, thr, state = _case(name)
    want = _jax_new_state(state, p, target, w, thr)
    old = torch.from_numpy(state.copy())
    args = (torch.from_numpy(p), torch.from_numpy(target), torch.from_numpy(w), torch.from_numpy(thr), C)
    got = tprc._binned_confmat_multiclass_accumulate_plain(old, *args)
    assert got.dtype == torch.int32 and got.shape == (len(thr), C, 2, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    # the dispatch takes the plain version for a CPU tensor, launches nothing and leaves the old state as it was
    launches = binned_confmat_multiclass.launches
    np.testing.assert_array_equal(tprc._binned_confmat_multiclass_accumulate(old, *args).numpy(), want)
    assert binned_confmat_multiclass.launches == launches
    np.testing.assert_array_equal(old.numpy(), state)


def _emulate_kernel(state, p, target, w, thr):
    """The CUDA kernel's algorithm, step for step, in numpy."""
    sorted_thr, order = (x.numpy() for x in tprc._sort_thresholds(torch.from_numpy(thr)))
    n_thr, n_bins = len(thr), len(thr) + 1
    padded = np.append(sorted_thr, np.float32(np.nan))
    # k = #{j : sorted_thr[j] <= p} by binary lifting from 0, the largest power of two <= T first
    k = np.zeros(p.shape, dtype=np.int64)
    with np.errstate(invalid="ignore"):
        step = 1 << (n_thr.bit_length() - 1)
        while step:
            k = k + np.where(padded[np.minimum(k + step - 1, n_thr)] <= p, step, 0)
            step >>= 1
    wi = w.astype(np.int64)  # static_cast<int>(weights[n])
    geometry = kbc.plan(len(p), C, n_thr, H100_SMS)
    hpos = np.zeros((n_bins, C), dtype=np.int64)
    rows, cols = np.nonzero(np.broadcast_to(wi[:, None] != 0, p.shape))  # ignored rows count nowhere
    for z in range(geometry.grid[2]):  # each bin range keeps its own bins
        lo, hi = z * geometry.bins_per_range, min((z + 1) * geometry.bins_per_range, n_bins)
        mine = (k[rows, cols] >= lo) & (k[rows, cols] < hi)
        np.add.at(hpos, (k[rows, cols][mine], cols[mine]), wi[rows][mine])
    htp = np.zeros((n_bins, C), dtype=np.int64)
    valid = (wi != 0) & (target >= 0) & (target < C)
    r_idx = np.nonzero(valid)[0]
    np.add.at(htp, (k[r_idx, target[r_idx]], target[r_idx]), wi[r_idx])
    actpos = np.bincount(target[r_idx], weights=wi[r_idx], minlength=C).astype(np.int64)
    total = int(wi.sum())
    # the histogram kernel's sums of each epilogue segment
    bpw = geometry.bins_per_warp
    seg_bins = kbc.EPI_WARPS * bpw
    segments = geometry.epilogue_grid[1]
    seg_pos = np.zeros((segments, C), np.int64)
    seg_tp = np.zeros((segments, C), np.int64)
    np.add.at(seg_pos, np.arange(n_bins) // seg_bins, hpos)
    np.add.at(seg_tp, np.arange(n_bins) // seg_bins, htp)
    # epilogue, block by block along the bins: the segments above the block's,
    # then the bins of the warps above, then each warp's own bins downward
    counts = np.full((n_thr, C, 2, 2), -(2**40), dtype=np.int64)
    for y in range(segments):
        seg_lo = min(y * seg_bins, n_bins)
        seg_hi = min(seg_lo + seg_bins, n_bins)
        for w in range(kbc.EPI_WARPS):
            k_lo = min(seg_lo + w * bpw, seg_hi)
            k_hi = min(k_lo + bpw, seg_hi)
            above_pos = seg_pos[y + 1 :].sum(0) + hpos[k_hi:seg_hi].sum(0)
            above_tp = seg_tp[y + 1 :].sum(0) + htp[k_hi:seg_hi].sum(0)
            for kk in range(k_hi - 1, max(k_lo, 1) - 1, -1):
                above_pos, above_tp = above_pos + hpos[kk], above_tp + htp[kk]
                fn = actpos - above_tp
                counts[order[kk - 1]] = np.stack(
                    [np.stack([total - above_pos - fn, above_pos - above_tp], -1), np.stack([fn, above_tp], -1)], -2
                )
    assert (counts > -(2**40)).all(), "a threshold's cells were not written"
    new = (state + counts).astype(np.int32)
    return new, geometry


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_algorithm_matches_jax(name):
    p, target, w, thr, state = _case(name, seed=1)
    got, _ = _emulate_kernel(state, p, target, w, thr)
    np.testing.assert_array_equal(got, _jax_new_state(state, p, target, w, thr))


def test_kernel_algorithm_with_split_bin_ranges():
    """T=4000 needs more bins than 32 classes' shared budget: the plan splits them."""
    rng = np.random.default_rng(5)
    thr = np.concatenate([tprc._linspace_grid(3990), [NAN, INF, -INF, 0.5, 0.5, 0.0, 1.0, NAN, 0.25, 2.0]])
    thr = thr.astype(np.float32)
    rng.shuffle(thr)
    p = _scores(rng, 24)
    p[::5, 2] = thr[:5]
    target = rng.integers(-2, C + 2, size=24).astype(np.int32)
    w = np.ones(24, np.float32)
    state = rng.integers(-100, 100, size=(len(thr), C, 2, 2)).astype(np.int32)
    got, geometry = _emulate_kernel(state, p, target, w, thr)
    assert geometry.tile_c == 32 and geometry.grid[2] == 6
    np.testing.assert_array_equal(got, _jax_new_state(state, p, target, w, thr))


SORT_CASES = {
    "grid": tprc._linspace_grid(20),
    "reversed": tprc._linspace_grid(20)[::-1].copy(),
    "duplicates": np.asarray([0.5, 0.1, 0.5, 0.1, 0.9, 0.5], np.float32),
    "nan_inf": np.asarray([0.3, NAN, -INF, 0.3, INF, NAN, 0.0, -0.0, 1.0], np.float32),
    "signed_zeros": np.asarray([0.0, -0.0, 0.0, -0.0], np.float32),
    "random": np.random.default_rng(3).random(300).astype(np.float32).round(2),
}


@pytest.mark.parametrize("name", list(SORT_CASES))
def test_sort_thresholds_matches_numpy_stable_argsort(name):
    thr = SORT_CASES[name]
    values, order = tprc._sort_thresholds(torch.from_numpy(thr))
    assert values.dtype == torch.float32 and order.dtype == torch.int32
    want = np.argsort(thr, kind="stable")
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(values.numpy().view(np.int32), thr[want].view(np.int32))


def _metric_pair(metric, **kwargs):
    return getattr(jc, metric)(num_classes=C, **kwargs), getattr(tc, metric)(num_classes=C, device="cpu", **kwargs)


@pytest.mark.parametrize("thresholds", [20, [0.9, 0.1, NAN, 0.5, 0.1, INF]], ids=["grid20", "edge_list"])
@pytest.mark.parametrize("metric", ["MulticlassAUROC", "MulticlassPrecisionRecallCurve"])
def test_metric_update_through_fused_update(metric, thresholds):
    jm, tm = _metric_pair(metric, thresholds=thresholds, ignore_index=-1, validate_args=False)
    assert torch.equal(tm._thresholds_order, tprc._sort_thresholds(tm.thresholds)[1])
    js, ts = jm.init_state(), tm.init_state()
    rng = np.random.default_rng(11)
    for step in range(4):
        p = _scores(rng, 64)
        target = rng.integers(-1, C, size=64).astype(np.int32)  # -1: ignored
        target[::13] = C + 1  # out of range: a negative everywhere
        js = jm.update_state(js, jnp.asarray(p), jnp.asarray(target))
        ts = tm.update_state(ts, torch.from_numpy(p), torch.from_numpy(target))
        if step == 1:  # a pickled metric carries its sorted thresholds along
            tm = pickle.loads(pickle.dumps(tm))
    np.testing.assert_array_equal(ts["confmat"].numpy(), np.asarray(js["confmat"]))
    assert int(ts["_n"]) == 4


def test_spatial_inputs_through_format_and_fused_update():
    rng = np.random.default_rng(21)
    logits = rng.normal(size=(6, C, 4, 5)).astype(np.float32)
    target = rng.integers(0, C, size=(6, 4, 5)).astype(np.int32)
    target[0, 0] = C + 2
    jm, tm = _metric_pair("MulticlassAUROC", thresholds=20, validate_args=False)
    js = jm.update_state(jm.init_state(), jnp.asarray(logits), jnp.asarray(target))
    ts = tm.update_state(tm.init_state(), torch.from_numpy(logits), torch.from_numpy(target))
    np.testing.assert_array_equal(ts["confmat"].numpy(), np.asarray(js["confmat"]))
    assert int(ts["confmat"][0, 0].sum()) == 6 * 4 * 5


def _good_inputs(n=8, t=5):
    thr, order = tprc._sort_thresholds(torch.linspace(0, 1, t))
    return {
        "confmat": torch.zeros((t, C, 2, 2), dtype=torch.int32),
        "probs": torch.rand((n, C)),
        "target": torch.zeros((n,), dtype=torch.int32),
        "weights": torch.ones((n,)),
        "sorted_thresholds": thr,
        "order": order,
    }


def _meta(**shapes):
    out = {k: v.to("meta") for k, v in _good_inputs().items()}
    for k, (shape, dtype) in shapes.items():
        out[k] = torch.empty(shape, dtype=dtype, device="meta")
    return out


BAD_INPUTS = {
    "cpu_tensors": (lambda: _good_inputs(), "CUDA"),
    "meta_tensors": (lambda: _meta(), "CUDA"),
    "probs_float64": (lambda: {**_good_inputs(), "probs": torch.rand((8, C), dtype=torch.float64)}, "dtype"),
    "probs_1d": (lambda: {**_good_inputs(), "probs": torch.rand((8 * C,))}, "dims"),
    "probs_strided": (lambda: {**_good_inputs(), "probs": torch.rand((C, 8)).T}, "contiguous"),
    "target_int64": (lambda: {**_good_inputs(), "target": torch.zeros((8,), dtype=torch.int64)}, "dtype"),
    "target_short": (lambda: {**_good_inputs(), "target": torch.zeros((7,), dtype=torch.int32)}, "shape"),
    "weights_int32": (lambda: {**_good_inputs(), "weights": torch.ones((8,), dtype=torch.int32)}, "dtype"),
    "thresholds_float64": (lambda: {**_good_inputs(), "sorted_thresholds": torch.linspace(0, 1, 5, dtype=torch.float64)}, "dtype"),
    "thresholds_2d": (lambda: {**_good_inputs(), "sorted_thresholds": torch.zeros((5, 1))}, "thresholds"),
    "no_thresholds": (lambda: {**_good_inputs(t=1), "sorted_thresholds": torch.zeros((0,))}, "thresholds"),
    "too_many_thresholds": (lambda: _meta(sorted_thresholds=((kbc.MAX_THRESHOLDS + 1,), torch.float32)), "thresholds"),
    "order_int64": (lambda: {**_good_inputs(), "order": torch.arange(5)}, "dtype"),
    "confmat_float32": (lambda: {**_good_inputs(), "confmat": torch.zeros((5, C, 2, 2))}, "dtype"),
    "confmat_wrong_shape": (lambda: {**_good_inputs(), "confmat": torch.zeros((5, C, 4), dtype=torch.int32)}, "shape"),
    "confmat_other_thresholds": (lambda: {**_good_inputs(), "confmat": torch.zeros((6, C, 2, 2), dtype=torch.int32)}, "shape"),
    "rows_2_to_the_31": (lambda: _meta(probs=((2**31, C), torch.float32)), "2\\*\\*31"),
}


@pytest.mark.parametrize("name", list(BAD_INPUTS))
def test_launcher_refuses_before_any_build(name, monkeypatch):
    def no_build(*_):
        raise AssertionError("the launcher reached the build")

    monkeypatch.setattr(kbc, "load_library", no_build)
    make, match = BAD_INPUTS[name]
    launches = binned_confmat_multiclass.launches
    with pytest.raises(ValueError, match=match):
        binned_confmat_multiclass(**make())
    assert binned_confmat_multiclass.launches == launches


PLAN_CASES = [  # (rows, classes, thresholds, tile_c, ranges)
    (1024, 1000, 20, 128, 1),
    (848, 1000, 20, 128, 1),
    (1024, 1000, 37, 128, 1),
    (1024, 1000, 190, 128, 1),
    (1024, 1000, 191, 64, 1),
    (1024, 1000, 200, 64, 1),
    (1024, 1001, 200, 64, 1),
    (1024, 1000, 1000, 32, 2),
    (256, 1000, 4000, 32, 6),
    (64, 11, kbc.MAX_THRESHOLDS, 32, 22),
    (0, 5, 3, 128, 1),
    (3, 100_000, 20, 128, 1),
]


@pytest.mark.parametrize("rows,classes,n_thr,tile_c,ranges", PLAN_CASES)
def test_launch_plan(rows, classes, n_thr, tile_c, ranges):
    geometry = kbc.plan(rows, classes, n_thr, H100_SMS)
    assert (geometry.tile_c, geometry.grid[2]) == (tile_c, ranges)
    # shared memory of a block, as the source sizes it: the bins padded to an odd count per
    # class, the thresholds and a NaN after them
    assert tile_c * (geometry.bins_per_range | 1) * 4 <= kbc.HIST_BUDGET
    assert (tile_c * (geometry.bins_per_range | 1) + n_thr + 1) * 4 <= 232_448  # 227 KB
    # the grid covers every class, row and bin, with balanced bin ranges
    x, y, z = geometry.grid
    assert x * tile_c >= classes > (x - 1) * tile_c
    assert y * geometry.rows_per_block >= max(rows, 1) > (y - 1) * geometry.rows_per_block
    assert z * geometry.bins_per_range >= n_thr + 1 > (z - 1) * geometry.bins_per_range
    assert y <= 65535
    bins_per_segment = kbc.EPI_WARPS * geometry.bins_per_warp
    ex, ey = geometry.epilogue_grid
    assert ex * 32 >= classes > (ex - 1) * 32
    assert ey * bins_per_segment >= n_thr + 1 > (ey - 1) * bins_per_segment
    if n_thr + 1 > kbc.EPI_WARPS:  # segments until the epilogue fills the card, or a bin a warp
        assert ex * ey >= 2 * H100_SMS or geometry.bins_per_warp == 1
    # at least two blocks an SM wherever the rows allow it
    if rows >= 2 * H100_SMS:
        assert x * y * z >= 2 * H100_SMS
