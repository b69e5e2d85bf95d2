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
    with pytest.raises(ValueError, match="not supported by the PyTorch port"):
        tc.BinaryCalibrationError(approx="sketch", **CPU)
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
    assert kce.plan(1024, 1000, 15, 132) == kce.Plan("rows", 128, 256, 16 * 16 + 66 * 4)
    assert kce.plan(1024, None, 15, 132) == kce.Plan("binary", 4, 256, 16 * 16 + 66 * 4)
    assert kce.plan(10**6, 3, 15, 132).mode == "short_rows" and kce.plan(10**6, 3, 15, 132).blocks == 264
    assert kce.plan(64, 2000, 15, 132).mode == "long_rows"
    assert kce.plan(1024, 1024, 15, 132).mode == "rows" and kce.plan(1024, 31, 15, 132).mode == "short_rows"
    assert kce.plan(1, 32, kce.MAX_BINS, 132).shared_bytes <= 48 * 1024  # the stated limit fits without opting in


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
