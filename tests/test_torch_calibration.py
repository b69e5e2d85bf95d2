"""Parity of the port's calibration error with the JAX package, and the ``calibration_bins`` launcher.

The same seeded numpy inputs go through both packages; the port runs on the
CPU, where the state update is the plain version of the ``calibration_bins``
kernel (``chip_smoke.py`` holds the kernel against it on the card). The
integer states (``acc_sum``, ``count``) must be equal; ``conf_sum`` and the
errors within 1e-5 relative (float32 sums in another order than XLA's).

Over logits, a row may cross a bin edge where the two softmaxes differ in
the last bit: only rows whose JAX confidence x ``n_bins`` lies within 1e-5 of
an integer may move. ``test_logit_rows_near_a_bin_edge`` counts them on
these inputs: there are none, so the states here must be equal.

Inputs cover NaN and +-inf confidences, confidences exactly on ``k / n_bins``
and exactly 1.0, the ``(N, C, S)`` reshape (the class axis is not moved),
float16 and bfloat16 scores, ``ignore_index`` None, -1 and 255, and the
``jnp.argmax`` tie and NaN rules.
"""

import importlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu.collections as jcol
import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.collections as tcol
from torchmetrics_tpu_torch.convert import state_from_jax
from torchmetrics_tpu_torch.kernels import calibration as kce
from torchmetrics_tpu_torch.utilities.compute import normalize_logits_if_needed

jce = importlib.import_module("torchmetrics_tpu.functional.classification.calibration_error")
tce = importlib.import_module("torchmetrics_tpu_torch.functional.classification.calibration_error")

CPU = {"device": "cpu"}
RTOL = 1e-5
N, C = 96, 5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(_np(got).astype(np.float64), np.asarray(want, np.float64), rtol=rtol, atol=atol,
                               equal_nan=True)


def _equal(got, want):
    g, w = _np(got), np.asarray(want)
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def _multiclass(seed, n=N, c=C, logits=False, spatial=(), edits=()):
    rng = np.random.default_rng(seed)
    target = rng.integers(0, c, (n, *spatial)).astype(np.int64)
    raw = rng.normal(scale=2.0, size=(n, c, *spatial)).astype(np.float32)
    if logits:
        scores = raw
    else:
        e = np.exp(raw - raw.max(1, keepdims=True))
        scores = (e / e.sum(1, keepdims=True)).astype(np.float32)
    if "ties" in edits:  # the first of equal maxima wins
        scores[::7] = scores[::7].max(1, keepdims=True) if logits else 1.0 / c
    if "nan" in edits:
        scores[1::9, c // 2] = np.nan
    if "onehot" in edits:  # confidence exactly 1.0: the last bin
        scores[2::11] = 0.0
        scores[2::11, 0] = 1.0
    if "ignore" in edits:
        target[::5] = -1
    return scores, target


def _binary(seed, n=N, logits=False, edits=()):
    rng = np.random.default_rng(seed)
    p = rng.uniform(size=n).astype(np.float32)
    t = (rng.uniform(size=n) < p).astype(np.int64)
    if logits:
        p = np.log(p / (1 - p)).astype(np.float32)
    if "edges" in edits:  # exactly on k / 3 and k / 15 edges, 0 and 1
        p[::6] = 0.2
        p[1::6] = 1.0
        p[2::6] = 0.0
        p[3::6] = np.float32(2.0 / 3.0)
    if "nan" in edits:
        p[4::13] = np.nan
    if "ignore" in edits:
        t[::7] = 255
    return p, t


# --------------------------------------------------------------- _bin_update
SPECIAL_CONF = np.array([0.0, 1.0, 0.5, 1 / 3, 2 / 3, 0.2, 0.999, np.nan, np.inf, -np.inf, -0.5, 1.5, 1e-30,
                         np.float32(14 / 15), np.float32(1 / 15)], np.float32)


@pytest.mark.parametrize("n_bins", [1, 3, 15, 100])
def test_bin_update_special_confidences(n_bins):
    rng = np.random.default_rng(n_bins)
    conf = np.concatenate([SPECIAL_CONF, rng.uniform(size=40).astype(np.float32)])
    acc = (rng.uniform(size=conf.shape) < 0.5).astype(np.float32)
    w = (rng.uniform(size=conf.shape) < 0.8).astype(np.float32)
    want = jce._bin_update(jnp.asarray(conf), jnp.asarray(acc), jnp.asarray(w), n_bins)
    got = tce._bin_update(torch.from_numpy(conf), torch.from_numpy(acc), torch.from_numpy(w), n_bins)
    for g, wv in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (n_bins + 1,)
        _close(g, wv, rtol=1e-6)


def test_bin_index_cast_rule():
    """JAX casts floor(NaN) to 0 and floor(+inf) to INT32_MAX before the clip; torch casts
    both to INT32_MIN, so the port clamps first: NaN in bin 0, +inf in bin n_bins."""
    conf = torch.tensor([float("nan"), float("inf"), float("-inf"), 1.0, 0.0, 0.9999999])
    assert tce._bin_index(conf, 10).tolist() == [0, 10, 0, 10, 0, 9]
    want = np.asarray(jnp.clip(jnp.floor(jnp.asarray(conf.numpy()) * 10).astype(jnp.int32), 0, 10))
    np.testing.assert_array_equal(tce._bin_index(conf, 10).numpy(), want)


# ------------------------------------------------------------- confidences
MC_CASES = {
    "probs": {},
    "logits": {"logits": True},
    "spatial-probs": {"spatial": (3,)},
    "spatial-logits": {"logits": True, "spatial": (2, 2)},
    "ties": {"edits": ("ties",)},
    "ties-logits": {"logits": True, "edits": ("ties",)},
    "nan": {"edits": ("nan",)},
    "nan-logits": {"logits": True, "edits": ("nan",)},
    "onehot": {"edits": ("onehot",)},
    "ignore": {"edits": ("ignore",)},
}


@pytest.mark.parametrize("ignore_index", [None, -1, 255])
@pytest.mark.parametrize("case", list(MC_CASES))
def test_multiclass_confidences(case, ignore_index):
    preds, target = _multiclass(3, **MC_CASES[case])
    want = jce._multiclass_ce_confidences(jnp.asarray(preds), jnp.asarray(target), C, ignore_index)
    got = tce._multiclass_ce_confidences(torch.from_numpy(preds), torch.from_numpy(target), C, ignore_index)
    _close(got[0], want[0], rtol=1e-6)
    _equal(got[1], want[1])  # argmax == target, with the tie and NaN rules
    _equal(got[2], want[2])


@pytest.mark.parametrize("edits", [(), ("edges",), ("nan",), ("ignore",)], ids=["plain", "edges", "nan", "ignore"])
@pytest.mark.parametrize("logits", [False, True], ids=["probs", "logits"])
def test_binary_confidences(logits, edits):
    preds, target = _binary(4, logits=logits, edits=edits)
    ignore_index = 255 if "ignore" in edits else None
    want = jce._binary_ce_confidences(jnp.asarray(preds), jnp.asarray(target), ignore_index)
    got = tce._binary_ce_confidences(torch.from_numpy(preds), torch.from_numpy(target), ignore_index)
    _close(got[0], want[0], rtol=1e-6)
    _equal(got[1], want[1])
    _equal(got[2], want[2])


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("logits", [False, True], ids=["probs", "logits"])
def test_half_scores_widen_like_jax(dtype, logits):
    preds, target = _multiclass(5, logits=logits)
    half = torch.from_numpy(preds).to(getattr(torch, dtype))
    want = jce._multiclass_ce_confidences(jnp.asarray(half.float().numpy()).astype(getattr(jnp, dtype)),
                                          jnp.asarray(target), C, None)
    got = tce._multiclass_ce_confidences(half, torch.from_numpy(target), C, None)
    _close(got[0], want[0], rtol=1e-6)
    _equal(got[1], want[1])


# -------------------------------------------------------------- functional
@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("case", ["probs", "logits", "spatial-logits", "nan", "ignore"])
def test_multiclass_calibration_error(case, norm):
    preds, target = _multiclass(6, **MC_CASES[case])
    ignore_index = -1 if case == "ignore" else None
    want = jce.multiclass_calibration_error(jnp.asarray(preds), jnp.asarray(target), C, 10, norm, ignore_index)
    got = tce.multiclass_calibration_error(torch.from_numpy(preds), torch.from_numpy(target), C, 10, norm, ignore_index)
    _close(got, want)


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("edits", [(), ("edges",), ("nan",), ("ignore",)], ids=["plain", "edges", "nan", "ignore"])
def test_binary_calibration_error(edits, norm):
    preds, target = _binary(7, edits=edits)
    ignore_index = 255 if "ignore" in edits else None
    want = jce.binary_calibration_error(jnp.asarray(preds), jnp.asarray(target), 15, norm, ignore_index)
    got = tce.binary_calibration_error(torch.from_numpy(preds), torch.from_numpy(target), 15, norm, ignore_index)
    _close(got, want)


def test_task_dispatch_and_validation():
    preds, target = _binary(8)
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    _close(tce.calibration_error(p, t, "binary", n_bins=5),
           jce.calibration_error(jnp.asarray(preds), jnp.asarray(target), "binary", n_bins=5))
    mp, mt = _multiclass(8)
    _close(tce.calibration_error(torch.from_numpy(mp), torch.from_numpy(mt), "multiclass", num_classes=C),
           jce.calibration_error(jnp.asarray(mp), jnp.asarray(mt), "multiclass", num_classes=C))
    for bad in ({"task": "multilabel"}, {"task": "multiclass"}):
        with pytest.raises(ValueError):
            tce.calibration_error(p, t, **bad)
    with pytest.raises(ValueError, match="n_bins"):
        tce.binary_calibration_error(p, t, n_bins=0)
    with pytest.raises(ValueError, match="norm"):
        tce._ce_compute_from_bins(*tce._zero_bins(3, torch.device("cpu")), norm="l3")


# ----------------------------------------------------------------- classes
CLASS_CASES = [
    ("BinaryCalibrationError", {"n_bins": 15}, "binary", {}),
    ("BinaryCalibrationError", {"n_bins": 3, "norm": "max", "ignore_index": 255}, "binary", {"edits": ("ignore",)}),
    ("BinaryCalibrationError", {"n_bins": 15, "norm": "l2"}, "binary", {"logits": True}),
    ("MulticlassCalibrationError", {"num_classes": C, "n_bins": 15}, "multiclass", {}),
    ("MulticlassCalibrationError", {"num_classes": C, "n_bins": 15, "norm": "l2"}, "multiclass", {"logits": True}),
    ("MulticlassCalibrationError", {"num_classes": C, "n_bins": 100, "norm": "max", "ignore_index": -1}, "multiclass",
     {"edits": ("ignore", "ties")}),
    ("MulticlassCalibrationError", {"num_classes": C, "n_bins": 7}, "multiclass", {"logits": True, "spatial": (3,)}),
]


def _batch(task, seed, opts):
    return _binary(seed, **opts) if task == "binary" else _multiclass(seed, **opts)


def _state_np(state):
    return {k: ([np.asarray(x) for x in v] if isinstance(v, (tuple, list)) else np.asarray(v)) for k, v in state.items()}


def _assert_states(got, want):
    _close(got["conf_sum"], want["conf_sum"])
    assert got["conf_sum"].dtype == torch.float32
    _equal(got["acc_sum"], want["acc_sum"])
    _equal(got["count"], want["count"])


@pytest.mark.parametrize("name,kwargs,task,opts", CLASS_CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CLASS_CASES)])
def test_metric_update_compute_forward(name, kwargs, task, opts):
    jm, tm = getattr(jc, name)(**kwargs), getattr(tc, name)(**kwargs, **CPU)
    for seed in range(3):
        p, t = _batch(task, 10 + seed, opts)
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    _assert_states(tm.metric_state, jm.metric_state)
    _close(tm.compute(), jm.compute())
    p, t = _batch(task, 20, opts)
    _close(tm(torch.from_numpy(p), torch.from_numpy(t)), jm(jnp.asarray(p), jnp.asarray(t)))
    _assert_states(tm.metric_state, jm.metric_state)
    # a JAX state carries over with its dtypes, and computes the same
    loaded = state_from_jax(tm, _state_np(jm.metric_state))
    assert [loaded[k].dtype for k in ("conf_sum", "acc_sum", "count")] == [torch.float32, torch.int32, torch.int32]
    _close(tm.compute_state(loaded), jm.compute())


def test_logit_rows_near_a_bin_edge():
    """Rows of the logit inputs above whose JAX confidence x n_bins lies within 1e-5 of an
    integer: the only rows allowed to change bins between the packages. There are none."""
    near = 0
    for seed in range(10, 21):
        for task, n_bins in (("binary", 15), ("multiclass", 15), ("multiclass", 7)):
            p, t = _batch(task, seed, {"logits": True})
            fn = jce._binary_ce_confidences if task == "binary" else (
                lambda a, b, i: jce._multiclass_ce_confidences(a, b, C, i))
            conf = np.asarray(fn(jnp.asarray(p), jnp.asarray(t), None)[0], np.float64) * n_bins
            near += int((np.abs(conf - np.round(conf)) < 1e-5).sum())
    assert near == 0


def test_wrapper_collection_and_pickle():
    assert type(tc.CalibrationError(task="binary", num_classes=3, **CPU)) is tc.BinaryCalibrationError
    assert type(tc.CalibrationError(task="multiclass", num_classes=3, **CPU)) is tc.MulticlassCalibrationError
    with pytest.raises(ValueError, match="not supported"):
        tc.CalibrationError(task="multilabel", **CPU)
    # sketch mode is ported (a 200-bin grid of float32 leaves); an approx_error past 0.5 stays refused, as in JAX
    sketch = tc.BinaryCalibrationError(approx="sketch", **CPU)
    assert sketch.n_bins == 200 and sketch._defaults["count"].dtype == torch.float32
    with pytest.raises(ValueError, match="approx_error"):
        tc.BinaryCalibrationError(approx="sketch", approx_error=0.7, **CPU)
    kw = {"num_classes": C, "n_bins": 10}
    jcoll = jcol.MetricCollection({n: jc.MulticlassCalibrationError(norm=n, **kw) for n in ("l1", "l2", "max")})
    tcoll = tcol.MetricCollection({n: tc.MulticlassCalibrationError(norm=n, **kw, **CPU) for n in ("l1", "l2", "max")})
    for seed in range(3):
        p, t = _multiclass(30 + seed, logits=True)
        jcoll.update(jnp.asarray(p), jnp.asarray(t))
        tcoll.update(torch.from_numpy(p), torch.from_numpy(t))
    assert [sorted(g) for g in tcoll.compute_groups.values()] == [["l1", "l2", "max"]]
    want, got = jcoll.compute(), tcoll.compute()
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])
    clone = pickle.loads(pickle.dumps(tcoll["l1"]))
    _close(clone.compute(), got["l1"])


# ----------------------------------------------- plain version vs float64 numpy
def _literal(preds, target, c, ignore_index, n_bins):
    """The update by its definition, in float64 numpy (binary: c None)."""
    x = preds.astype(np.float64).reshape(-1) if c is None else preds.astype(np.float64).reshape(-1, c)
    t = target.reshape(-1)
    w = np.ones(t.shape) if ignore_index is None else (t != ignore_index).astype(np.float64)
    t = np.where(w > 0, t, 0)
    outside = (x < 0).any() or (x > 1).any()
    if c is None:
        conf = 1 / (1 + np.exp(-x)) if outside else x
        acc = t.astype(np.float64)
    else:
        probs = np.exp(x - x.max(1, keepdims=True)) if outside else x
        probs = probs / probs.sum(1, keepdims=True) if outside else probs
        conf, acc = probs.max(1), (probs.argmax(1) == t).astype(np.float64)
    bins = np.clip(np.floor(conf * n_bins), 0, n_bins).astype(np.int64)
    return [np.bincount(bins, weights=v * w, minlength=n_bins + 1) for v in (conf, acc, np.ones_like(conf))]


@pytest.mark.parametrize("shape", [("binary", 64, None), ("probs", 64, 3), ("logits", 50, 7), ("logits", 33, 40)],
                         ids=lambda s: f"{s[0]}-{s[1]}x{s[2]}")
def test_plain_update_against_float64_numpy(shape):
    kind, n, c = shape
    n_bins, ignore_index = 15, -1
    if c is None:
        preds, target = _binary(40, n=n)
    else:
        preds, target = _multiclass(40, n=n, c=c, logits=kind == "logits")
    target[::9] = -1
    state = (torch.full((n_bins + 1,), 2.5), torch.full((n_bins + 1,), 3, dtype=torch.int32),
             torch.full((n_bins + 1,), 4, dtype=torch.int32))
    got = tce._calibration_accumulate_plain(state, torch.from_numpy(preds), torch.from_numpy(target), c, ignore_index)
    conf, acc, count = _literal(preds, target, c, ignore_index, n_bins)
    _close(got[0], 2.5 + conf, rtol=1e-6)
    _equal(got[1], (3 + acc).astype(np.int32))
    _equal(got[2], (4 + count).astype(np.int32))
    # the dispatch takes the plain version for CPU tensors
    again = tce._calibration_accumulate(state, torch.from_numpy(preds), torch.from_numpy(target), c, ignore_index)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


# ----------------------------------------------------------------- launcher
def test_plan_geometry():
    shared15 = 16 * 16 + 68 * 4  # two histograms of 16 bins: uint64 sums, then acc, count, nan, outside, ticket
    # the ImageNet-1k batch and its last batch: four warps a row, every row's warps in one wave
    assert kce.plan(1024, 1000, 15, 132) == kce.Plan("rows", 4, 512, 256, shared15)
    assert kce.plan(848, 1000, 15, 132) == kce.Plan("rows", 4, 424, 256, shared15)
    # fewer warps a row as the rows outgrow the wave of 4 x 132 blocks of 8 warps (4,224 warps): four
    # while every row's four fit it, two while the rows would fit it at one warp each, then one
    assert [kce.plan(n, 1000, 15, 132).warps_per_row
            for n in (1056, 1057, 2048, 4224, 4225, 16_384, 50_000)] == [4, 2, 2, 2, 1, 1, 1]
    assert kce.plan(50_000, 1000, 15, 132).blocks == kce.BLOCKS_PER_SM * 132
    assert kce.plan(2048, 1000, 15, 132) == kce.Plan("rows", 2, 512, 256, shared15)
    assert kce.plan(4224, 1000, 15, 132).blocks == kce.plan(16_384, 1000, 15, 132).blocks == 528
    # one block when the batch fits one round of a block: it writes the state itself
    assert kce.plan(1024, None, 15, 132) == kce.Plan("binary", 1, 1, 256, shared15)  # the binary batch
    assert kce.plan(848, None, 15, 132).blocks == 1 and kce.plan(1025, None, 15, 132).blocks == 2
    assert kce.plan(2, 1000, 15, 132).blocks == 1 and kce.plan(3, 1000, 15, 132).blocks == 2
    assert kce.plan(256, 3, 15, 132).blocks == 1 and kce.plan(257, 3, 15, 132).blocks == 2
    assert kce.plan(10**6, 3, 15, 132) == kce.Plan("short_rows", 1, 528, 256, shared15)
    assert kce.plan(64, 2000, 15, 132).mode == "long_rows" and kce.plan(64, 2000, 15, 132).blocks == 8
    assert kce.plan(1024, 1024, 15, 132).mode == "rows" and kce.plan(1024, 31, 15, 132).mode == "short_rows"
    # the stream's accumulator is laid out as a block's histograms; at the most bins both fit 48 KB
    # without opting in, with the row passes' static exchange arrays
    assert kce.SCRATCH_BYTES == kce.plan(1, 32, kce.MAX_BINS, 132).shared_bytes == 2 * 1024 * 8 + (4 * 1024 + 4) * 4
    assert kce.SCRATCH_BYTES + 4 * 8 * 4 <= 48 * 1024


# ------------------------------------------- a numpy model of the kernel's algorithm
F32 = np.float32
TIE_FLOOR = F32(1 - 2**-22)  # the kernel's register path divides only the e = exp(x - max) at or above it
NEAR_ONE = F32(1 - 2**-24)


def _exp32(x):
    """float32 exp, correctly rounded but for double rounding (numpy's float32 exp is not)."""
    with np.errstate(over="ignore", invalid="ignore"):
        return np.exp(x.astype(np.float64)).astype(F32)


def _first_argmax(x):
    """jnp.argmax of each row: the first NaN, else the first maximum; the max with NaN propagated."""
    nan = np.isnan(x)
    finite = np.where(nan, -np.inf, x)
    arg = np.where(nan.any(1), nan.argmax(1), finite.argmax(1))
    best = np.where(nan.any(1), np.nan, finite.max(1)).astype(F32)
    return best, arg


def _lane_layout(c, warps, vec_width):
    """Each score's (lane place among the row's 32 W lanes, register slot), as the kernel lays a row out."""
    k = np.arange(c)
    lanes = 32 * warps
    if vec_width:
        return (k // vec_width) % lanes, (k // vec_width) // lanes * vec_width + k % vec_width
    return k % lanes, k // lanes


def _row_sums(e, warps, vec_width):
    """The kernel's float32 sum of each row: a lane's slots in order, a butterfly in each warp,
    then the warps in order (a thread a row below 32 scores: in order)."""
    rows, c = e.shape
    if c < 32:
        total = np.zeros(rows, F32)
        for k in range(c):
            total = total + e[:, k]
        return total
    place, slot = _lane_layout(c, warps, vec_width)
    grid = np.zeros((rows, 32 * warps, slot.max() + 1), F32)
    grid[:, place, slot] = e
    lane = np.zeros((rows, 32 * warps), F32)
    for u in range(grid.shape[2]):
        lane = lane + grid[:, :, u]
    lane = lane.reshape(rows, warps, 32)
    for offset in (16, 8, 4, 2, 1):
        lane = lane + lane[:, :, np.arange(32) ^ offset]
    total = lane[:, 0, 0]
    for p in range(1, warps):
        total = total + lane[:, p, 0]
    return total


def _probability_argmax(e, total):
    """The kernel's argmax of e / total: pbest = 1 / total, the lowest k whose e passes the filter
    and whose e / total rounds to pbest. A NaN total (a NaN, +inf or all -inf row) gives NaN and
    index 0."""
    with np.errstate(invalid="ignore", divide="ignore"):
        pbest = F32(1) / total
        cand = (e >= TIE_FLOOR) & ((e == 1) | (e / total[:, None] == pbest[:, None]))
    return pbest, np.where(np.isnan(total), 0, cand.argmax(1))


def _vec_width(c, itemsize):
    """Scores a 16-byte load, as the kernel reads a row of C scores of ``itemsize`` bytes: 16 / itemsize
    where the row is a whole number of 16-byte loads and stays in registers; 0 (scalar loads) else."""
    return 16 // itemsize if c * itemsize % 16 == 0 and 32 <= c <= 1024 else 0


def _kernel_model(preds, target, c, ignore_index, n_bins, warps=1, itemsize=4):
    """The state a zero state takes after one batch, by the kernel's algorithm: both variants of
    each row binned, the whole-batch predicate choosing one, confidences summed in 32.32 fixed
    point. ``preds`` are the scores widened to float32 (numpy), ``itemsize`` the bytes of a score as
    the kernel reads it, ``c`` None for binary scores."""
    x = preds.reshape(-1) if c is None else preds.reshape(-1, c)
    t = target.reshape(-1).astype(np.int64).astype(np.int32).astype(np.int64)  # an int64 label's low 32 bits
    w = np.ones(t.shape, bool) if ignore_index is None else t != ignore_index
    t = np.where(w, t, 0)
    outside = bool(((x < 0) | (x > 1)).any())
    if c is None:
        with np.errstate(over="ignore"):
            sig = F32(1) / (F32(1) + _exp32(-x))
        variants = [(x, t), (sig, t)]
    else:
        best, arg = _first_argmax(x)
        with np.errstate(invalid="ignore"):
            e = _exp32(x - best[:, None])
        vec_width = _vec_width(c, itemsize)
        if c > 1024:  # a warp a row, read lane by lane
            warps = 1
        pbest, parg = _probability_argmax(e, _row_sums(e, warps, vec_width))
        variants = [(best, arg == t), (pbest, parg == t)]
    conf, acc = variants[int(outside)]
    with np.errstate(invalid="ignore"):
        bins = np.floor(conf * F32(n_bins))
    bins = np.where(np.isnan(bins), 0, np.clip(bins, 0, n_bins)).astype(np.int64)
    fixed = np.rint(np.clip(np.nan_to_num(conf.astype(np.float64)), 0, 1) * 2.0**32).astype(np.uint64)
    counted = w & ~np.isnan(conf)
    conf_fixed = np.bincount(bins[counted], weights=None, minlength=n_bins + 1).astype(np.uint64) * 0
    np.add.at(conf_fixed, bins[counted], fixed[counted])
    conf_sum = (conf_fixed.astype(np.float64) / 2.0**32).astype(F32)
    if np.isnan(conf).any():
        conf_sum[0] = np.nan
    acc_sum = np.bincount(bins[w], weights=acc[w].astype(np.float64), minlength=n_bins + 1).astype(np.int32)
    count = np.bincount(bins[w], minlength=n_bins + 1).astype(np.int32)
    return conf_sum, acc_sum, count


def _near_tie_logits(seed, n, c):
    """Logit rows (max 0) where e = exp(x - max) is exactly 1 or 1 - 2^-24 below the raw argmax,
    the other scores -100 (e ~ 0, absorbed in any order), so every sum order gives the same
    float32 sum: rows of kind 0 tie an e of 1 at index 0 (x = -2^-27) with the max at 3; kind 1
    tie 1 - 2^-24 at 0 (x = -2^-24; sum 6.25, where (1 - 2^-24) / 6.25 rounds to 1 / 6.25) with
    five maxima from 1 and an e of 0.25; kind 2 leave 1 - 2^-24 at 0 below 1 / 3 (sum 3); the
    rest are random logits. The target is 0 on every constructed row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=2.0, size=(n, c)).astype(F32)
    target = rng.integers(0, c, n).astype(np.int64)
    for kind, rows in enumerate((slice(0, None, 4), slice(1, None, 4), slice(2, None, 4))):
        x[rows] = -100.0
        target[rows] = 0
    x[0::4, 0], x[0::4, 3] = -(2.0**-27), 0.0
    x[1::4, 0], x[1::4, 1:6], x[1::4, 6] = -(2.0**-24), 0.0, F32(np.log(0.25))
    x[2::4, 0], x[2::4, 1:3] = -(2.0**-24), 0.0
    return x, target


def _model_case(case):
    """(preds as given to JAX, preds widened to float32, target, C, ignore_index, n_bins)."""
    kind, c = case
    rng = np.random.default_rng(hash(case) % 2**32)
    ignore_index = None
    if kind.startswith("binary"):
        p, t = _binary(50, n=200, logits="logits" in kind, edits=("nan", "ignore") if "edits" in kind else ())
        ignore_index = 255 if "edits" in kind else None
        return p, p, t, None, ignore_index, 15
    if kind == "near-tie logits":
        p, t = _near_tie_logits(51, 96, c)
    else:
        p, t = _multiclass(52, n=96, c=c, logits="logits" in kind, edits=("ties", "nan") if "edits" in kind else ())
    if kind == "nan and inf logits":
        p[3::10, c // 3] = np.inf
        p[5::10] = -np.inf
    if kind == "ignore_index":
        t[rng.uniform(size=t.shape) < 0.2] = -1
        ignore_index = -1
    if kind in ("float16 logits", "bfloat16 probs"):
        half = torch.from_numpy(p).to(torch.float16 if kind.startswith("float16") else torch.bfloat16)
        return half, half.float().numpy(), t, c, ignore_index, 15
    return p, p, t, c, ignore_index, 15


MODEL_CASES = [("probs", 40), ("logits", 40), ("near-tie logits", 40), ("near-tie logits", 33), ("near-tie logits", 7),
               ("near-tie logits", 1100), ("nan and inf logits", 40), ("edits logits", 36), ("edits", 40),
               ("ignore_index", 40), ("float16 logits", 40), ("bfloat16 probs", 40), ("logits", 3),
               ("binary", None), ("binary logits", None), ("binary logits edits", None)]


MODEL_PARAMS = [(case, w) for case in MODEL_CASES for w in ((1, 2, 4) if case[1] and 32 <= case[1] <= 1024 else (1,))]


@pytest.mark.parametrize("case,warps", MODEL_PARAMS, ids=[f"{c[0]}-C{c[1]}-W{w}" for c, w in MODEL_PARAMS])
def test_kernel_model_against_jax(case, warps):
    """The kernel's algorithm (the filtered argmax at 1 / sum, fixed-point sums, the whole-batch pick), in
    numpy, with W warps a row, equals the JAX update: integer states equal, conf_sum within 1e-5
    relative; the torch plain version too."""
    given, wide, target, c, ignore_index, n_bins = _model_case(case)
    jpreds = jnp.asarray(wide).astype(jnp.float16 if str(getattr(given, "dtype", "")) == "torch.float16" else
                                      jnp.bfloat16 if str(getattr(given, "dtype", "")) == "torch.bfloat16" else jnp.float32)
    conf_fn = (jce._binary_ce_confidences if c is None else
               lambda p, t, i: jce._multiclass_ce_confidences(p, t, c, i))
    want = jce._bin_update(*conf_fn(jpreds, jnp.asarray(target), ignore_index), n_bins)
    got = _kernel_model(wide, target, c, ignore_index, n_bins, warps, getattr(given, "itemsize", 4))
    _close(got[0], want[0])
    _equal(got[1], np.asarray(want[1]).astype(np.int32))
    _equal(got[2], np.asarray(want[2]).astype(np.int32))
    plain = tce._calibration_accumulate_plain(tce._zero_bins(n_bins, torch.device("cpu")), torch.as_tensor(given),
                                              torch.from_numpy(target), c, ignore_index)
    _close(plain[0], got[0])
    _equal(plain[1], got[1])  # the plain version's softmax divides, as JAX's does: the near-tie rows agree
    _equal(plain[2], got[2])
    if case[0] == "near-tie logits":  # the constructed rows: the probability argmax left the raw one
        best, arg = _first_argmax(wide.reshape(-1, c))
        e = _exp32(wide.reshape(-1, c) - best[:, None])
        _, parg = _probability_argmax(e, _row_sums(e, warps, _vec_width(c, 4)))
        assert (arg[0::4] == 3).all() and (parg[0::4] == 0).all()  # e = 1 below the max
        assert (arg[1::4] == 1).all() and (parg[1::4] == 0).all()  # 1 - 2^-24 ties 1 / 6.25
        assert (arg[2::4] == 1).all() and (parg[2::4] == 1).all()  # 1 - 2^-24 below 1 / 3
        # the plain version's probabilities take JAX's argmax on every row, the near ties too
        jprobs = np.asarray(jax.nn.softmax(jnp.asarray(wide), axis=1))
        pprobs = normalize_logits_if_needed(torch.from_numpy(wide), "softmax").numpy()
        np.testing.assert_array_equal(pprobs.argmax(1), jprobs.argmax(1))
        assert (pprobs.argmax(1)[1::4] == parg[1::4]).all()


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("warps", [1, 2, 4])
def test_half_rows_take_eight_scores_a_load(dtype, warps):
    """A row of 2-byte scores is read 8 to a 16-byte load, not 4: the two layouts sum some rows
    differently in float32, and the model with the kernel's layout equals the JAX update."""
    assert _vec_width(96, 2) == 8 and _vec_width(96, 4) == 4 and _vec_width(36, 2) == 0 and _vec_width(20, 2) == 0
    rng = np.random.default_rng(61)
    given = torch.from_numpy(rng.normal(scale=2.0, size=(256, 96)).astype(F32)).to(dtype)
    wide = given.float().numpy()
    target = rng.integers(0, 96, 256).astype(np.int64)
    e = _exp32(wide - wide.max(1, keepdims=True))
    assert (_row_sums(e, warps, 8) != _row_sums(e, warps, 4)).any()
    jpreds = jnp.asarray(wide).astype(jnp.float16 if dtype == torch.float16 else jnp.bfloat16)
    want = jce._bin_update(*jce._multiclass_ce_confidences(jpreds, jnp.asarray(target), 96, None), 15)
    got = _kernel_model(wide, target, 96, None, 15, warps, given.itemsize)
    _close(got[0], want[0])
    _equal(got[1], np.asarray(want[1]).astype(np.int32))
    _equal(got[2], np.asarray(want[2]).astype(np.int32))


def test_argmax_of_probabilities_is_lowest_index_at_one_over_sum():
    """The largest e is 1, so the largest probability is 1 / sum and the argmax is the lowest index
    whose e / sum rounds to it: an e of 1 - 2^-24 ties it for about a third of the sums, and no
    smaller e ever does, so the filter (divide only e >= 1 - 2^-22) keeps exactly the ties."""
    rng = np.random.default_rng(60)
    total = np.concatenate([rng.uniform(1, 1024, 100_000), np.arange(1, 1025), np.arange(1, 64, 0.25)]).astype(F32)
    ladder = [F32(1.0), NEAR_ONE, F32(1 - 2**-23), F32(1 - 3 * 2**-24), TIE_FLOOR, np.nextafter(TIE_FLOOR, F32(0))]
    e = np.concatenate([np.array(ladder, F32), rng.uniform(0, 1, 58).astype(F32)])
    quotient_ties = e[None, :] / total[:, None] == (F32(1) / total)[:, None]
    filtered = (e[None, :] >= TIE_FLOOR) & ((e[None, :] == 1) | quotient_ties)
    np.testing.assert_array_equal(filtered, quotient_ties)
    assert quotient_ties[:, 0].all() and 0.2 < quotient_ties[:, 1].mean() < 0.45
    assert not quotient_ties[:, 2:].any()
    # the argmax of whole rows: the model against e / sum divided in full, lowest index first
    e_rows = rng.choice(np.array(ladder[:4] + [F32(0.5), F32(0.25)], F32), size=(4096, 12))
    e_rows[:, 7] = 1.0
    total = _row_sums(e_rows, 1, 0)
    with np.errstate(invalid="ignore"):
        divided = e_rows / total[:, None]
    _, parg = _probability_argmax(e_rows, total)
    np.testing.assert_array_equal(parg, divided.argmax(1))


def test_launcher_refuses_what_it_does_not_take():
    state = tce._zero_bins(15, torch.device("cpu"))
    preds, target = torch.rand(8, 4), torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kce.calibration_bins(*state, preds, target, 4)
    with pytest.raises(ValueError, match="at most"):
        kce.calibration_bins(*tce._zero_bins(kce.MAX_BINS + 1, torch.device("cpu")), preds, target, 4)
    with pytest.raises(ValueError, match="float32, float16 or bfloat16"):
        kce.calibration_bins(*state, preds.double(), target, 4)
    with pytest.raises(ValueError, match="int32 or int64"):
        kce.calibration_bins(*state, preds, target.float(), 4)
    with pytest.raises(ValueError, match="rows of num_classes"):
        kce.calibration_bins(*state, preds, target, 3)
    with pytest.raises(ValueError, match="targets"):
        kce.calibration_bins(*state, preds, target[:5], 4)
    with pytest.raises(ValueError, match="must be"):
        kce.calibration_bins(state[0].double(), *state[1:], preds, target, 4)
    with pytest.raises(ValueError, match="contiguous"):
        kce.calibration_bins(*state, preds.t(), target[:4], 8)
    assert kce.calibration_bins.launches == 0
