"""Every ``approx`` mode of the port's metric classes, held against the JAX package's on the CPU.

The same seeded numpy batches (one of them empty) go through both packages'
classes: the 12 curve classes (precision-recall curve, ROC, AUROC and
average precision, three tasks each) and the two calibration classes with
``approx="sketch"``, ``MeanAveragePrecision(approx="sketch")``,
``DistinctNGrams(approx="sketch")`` (HyperLogLog) and ``BLEUScore``,
``SacreBLEUScore`` and ``ROUGEScore`` with ``approx="reservoir"``.

Tolerances: the sketch leaves (histograms, counters, registers, reservoir
rows) equal JAX's bit for bit, calibration's ``conf_sum`` within 1e-6
relative (float32 sums in another order); the computed values within 1e-6
relative and 1e-7 absolute (float32 curve arithmetic; the host-side
estimates of mAP and the reservoirs are the same numpy code, equal).

One gloo world of 4 CPU ranks (``tests/helpers/torch_dist.py``) syncs a
sketch-mode AUROC, calibration error and mAP, a DistinctNGrams HyperLogLog
and BLEU and ROUGE reservoirs: each histogram and register leaf rides the
planner's fused buckets (one ``all_reduce`` a bucket, no shape exchange),
each reservoir is one fixed-shape ``all_gather``, and every synced state
equals the state of one process over the whole stream, exactly (but
calibration's ``conf_sum``, a float32 sum of confidences taken in another
order: within 1e-6 relative).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

from tests.helpers.torch_dist import run_world, worker_main
from torchmetrics_tpu_torch import classification as tc
from torchmetrics_tpu_torch import text as tt
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.core.reductions import COLLECTIVES, SketchReduce
from torchmetrics_tpu_torch.detection import MeanAveragePrecision
from torchmetrics_tpu_torch.parallel.coalesce import plan_for_metrics

CPU = {"device": "cpu"}
RTOL, ATOL = 1e-6, 1e-7
WORLD = 4
C, L = 6, 5  # classes, labels
WORDS = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "fast", "home", "red", "blue", "big", "tree"]

CURVES = [f"{task}{family}" for family in ("PrecisionRecallCurve", "ROC", "AUROC", "AveragePrecision")
          for task in ("Binary", "Multiclass", "Multilabel")]


# ------------------------------------------------------------------ data
def _task(name):
    return "binary" if name.startswith("Binary") else "multiclass" if name.startswith("Multiclass") else "multilabel"


def _curve_kwargs(name, **extra):
    task = _task(name)
    kw = {"multiclass": {"num_classes": C}, "multilabel": {"num_labels": L}, "binary": {}}[task]
    return {**kw, **extra}


def _curve_batch(rng, task, n):
    """Scores with ties on the grid, a NaN-free batch of one task; multilabel with ignored (-1) targets."""
    if task == "binary":
        t = (rng.random(n) < 0.4).astype(np.int32)
        p = np.clip(rng.normal(0.35 + 0.3 * t, 0.25), 0, 1).astype(np.float32)
    elif task == "multiclass":
        t = rng.integers(0, C, n).astype(np.int32)
        logits = rng.normal(size=(n, C)).astype(np.float32)
        logits[np.arange(n), t] += 1.0
        p = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    else:
        t = (rng.random((n, L)) < 0.3).astype(np.int32)
        p = np.clip(rng.normal(0.3 + 0.4 * t, 0.2), 0, 1).astype(np.float32)
        t[rng.random((n, L)) < 0.05] = -1
    if n:
        p.reshape(-1)[:3] = [0.0, 1.0, 0.5]  # on grid edges
    return p, t


def _curve_batches(seed, task, sizes=(40, 0, 33)):
    rng = np.random.default_rng(seed)
    return [_curve_batch(rng, task, n) for n in sizes]


def _calib_batches(seed, binary, sizes=(50, 0, 31)):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        if binary:
            out.append((rng.random(n).astype(np.float32), rng.integers(0, 2, n).astype(np.int32)))
        else:
            logits = rng.normal(size=(n, C)).astype(np.float32) * 2
            out.append(((np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32),
                        rng.integers(0, C, n).astype(np.int32)))
    return out


def _sentences(rng, n, salt=""):
    return [" ".join(rng.choice(WORDS, int(rng.integers(1, 12)))) + f" s{salt}{i}" for i in range(n)]


def _text_batches(seed, sizes=(6, 0, 9)):
    rng = np.random.default_rng(seed)
    return [(_sentences(rng, n, f"{seed}_{j}_"), [[s] for s in _sentences(rng, n)]) for j, n in enumerate(sizes)]


def _token_batches(seed, sizes=((3, 17), (0, 17), (2, 9))):
    rng = np.random.default_rng(seed)
    out = []
    for shape in sizes:
        ids = rng.integers(0, 40, shape).astype(np.int32)
        ids[rng.random(shape) < 0.05] = -100
        out.append(ids)
    return out


def _boxes(rng, n):
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(5, 80, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _map_batches(seed, sizes=(3, 0, 2), classes=7):
    """Images of 0-6 ground truths and 0-9 detections (jittered copies and strays), 5 % crowds."""
    rng = np.random.default_rng(seed)
    out = []
    for n_img in sizes:
        preds, target = [], []
        for _ in range(n_img):
            g = int(rng.integers(0, 7))
            gt = _boxes(rng, g)
            keep = rng.random(g) < 0.8
            det = np.concatenate([gt[keep] + rng.normal(0, 4, (int(keep.sum()), 4)).astype(np.float32),
                                  _boxes(rng, int(rng.integers(0, 4)))])
            gl = rng.integers(0, classes, g)
            dl = np.concatenate([gl[keep], rng.integers(0, classes, len(det) - int(keep.sum()))])
            target.append({"boxes": gt, "labels": gl.astype(np.int64), "iscrowd": (rng.random(g) < 0.05).astype(np.int64)})
            preds.append({"boxes": det.astype(np.float32), "scores": rng.random(len(det)).astype(np.float32),
                          "labels": dl.astype(np.int64)})
        out.append((preds, target))
    return out


def _to_torch(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and x and not isinstance(x[0], str):
        return type(x)(_to_torch(v) for v in x)
    return x


def _to_jax(x):
    import jax.numpy as jnp

    if isinstance(x, np.ndarray):
        return jnp.asarray(x)
    if isinstance(x, dict):
        return {k: _to_jax(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and x and not isinstance(x[0], str):
        return type(x)(_to_jax(v) for v in x)
    return x


# ------------------------------------------------------------------ comparison helpers
def _flat(value):
    """A (nested) result as a list of float64 numpy arrays, in order."""
    if isinstance(value, dict):
        return [a for k in sorted(value) for a in _flat(value[k])]
    if isinstance(value, (list, tuple)):
        return [a for v in value for a in _flat(v)]
    return [np.asarray(value.cpu() if isinstance(value, torch.Tensor) else value, dtype=np.float64)]


def _close(got, want, rtol=RTOL, atol=ATOL):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape, (a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, equal_nan=True)


def _states_equal(tm, jm, float_rtol=None):
    """Every leaf of the port's state equal, in dtype and value, to the JAX state's (``float_rtol`` for the named
    float sums)."""
    assert set(tm.metric_state) == set(jm.metric_state)
    for name, want in jm.metric_state.items():
        got, want = tm.metric_state[name], np.asarray(want)
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        if float_rtol and name in float_rtol:
            np.testing.assert_allclose(got.numpy(), want, rtol=float_rtol[name], err_msg=name)
        else:
            assert np.array_equal(got.numpy(), want), name


def _run_both(make_t, make_j, batches, to_args):
    tm, jm = make_t(), make_j()
    for batch in batches:
        tm.update(*to_args(batch, _to_torch))
        jm.update(*to_args(batch, _to_jax))
    return tm, jm


def _pair(batch, conv):
    return conv(batch[0]), conv(batch[1])


# ------------------------------------------------------------------ the curve family
@pytest.mark.parametrize("name", CURVES)
@pytest.mark.parametrize("approx_error", [None, 0.02])
def test_curve_sketch_matches_jax(name, approx_error):
    from torchmetrics_tpu import classification as jc

    extra = {"ignore_index": -1} if _task(name) == "multilabel" else {}
    kw = _curve_kwargs(name, approx="sketch", approx_error=approx_error, **extra)
    tm, jm = _run_both(lambda: getattr(tc, name)(**kw, **CPU), lambda: getattr(jc, name)(**kw),
                       _curve_batches(11, _task(name)), _pair)
    assert isinstance(tm._reductions["score_hist"], SketchReduce)
    _states_equal(tm, jm)
    _close(tm.compute(), jm.compute())


FIXED_POINT = [f"{task}{family}" for family in ("PrecisionAtFixedRecall", "RecallAtFixedPrecision",
                                                "SensitivityAtSpecificity", "SpecificityAtSensitivity")
               for task in ("Binary", "Multiclass", "Multilabel")]


@pytest.mark.parametrize("name", FIXED_POINT)
def test_fixed_point_classes_take_the_sketch_as_jax(name):
    """The fixed operating-point classes are curve classes: sketch mode reaches them with no code of their own."""
    from torchmetrics_tpu import classification as jc

    task = _task(name)
    first = {"binary": (), "multiclass": (C,), "multilabel": (L,)}[task]
    tm, jm = _run_both(lambda: getattr(tc, name)(*first, 0.5, approx="sketch", **CPU),
                       lambda: getattr(jc, name)(*first, 0.5, approx="sketch"),
                       [(p, np.maximum(t, 0)) for p, t in _curve_batches(13, task)], _pair)
    _states_equal(tm, jm)
    _close(tm.compute(), jm.compute())


@pytest.mark.parametrize("name", ["BinaryAUROC", "MulticlassPrecisionRecallCurve", "MultilabelAveragePrecision",
                                  "MulticlassROC"])
def test_sketch_curve_equals_binned_at_grid_thresholds(name):
    """The sketch's curve is the binned curve at the sketch's edges (JAX's property), within 1e-6."""
    batches = _curve_batches(12, _task(name))
    sketch = getattr(tc, name)(**_curve_kwargs(name, approx="sketch"), **CPU)
    binned = getattr(tc, name)(**_curve_kwargs(name, thresholds=sketch.thresholds.tolist()), **CPU)
    for p, t in batches:
        sketch.update(torch.from_numpy(p), torch.from_numpy(np.maximum(t, 0)))
        binned.update(torch.from_numpy(p), torch.from_numpy(np.maximum(t, 0)))
    _close(sketch.compute(), binned.compute(), rtol=0, atol=1e-6)


def test_sketch_auroc_within_its_bound_of_exact():
    rng = np.random.default_rng(5)
    p, t = _curve_batch(rng, "multiclass", 3_000)
    sketch, exact = tc.MulticlassAUROC(num_classes=C, approx="sketch", **CPU), tc.MulticlassAUROC(num_classes=C, **CPU)
    sketch.update(torch.from_numpy(p), torch.from_numpy(t))
    exact.update(torch.from_numpy(p), torch.from_numpy(t))
    bound = float(sketch._sketch.auc_error_bound(sketch.metric_state["score_hist"]).max())
    assert abs(float(sketch.compute()) - float(exact.compute())) <= bound + 1e-6


# ------------------------------------------------------------------ calibration
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "multiclass"])
@pytest.mark.parametrize(("norm", "approx_error"), [("l1", None), ("l2", 0.1), ("max", 1 / 15)])
def test_calibration_sketch_matches_jax(binary, norm, approx_error):
    from torchmetrics_tpu import classification as jc

    name = "BinaryCalibrationError" if binary else "MulticlassCalibrationError"
    kw = {"norm": norm, "approx": "sketch", "approx_error": approx_error, **({} if binary else {"num_classes": C})}
    tm, jm = _run_both(lambda: getattr(tc, name)(**kw, **CPU), lambda: getattr(jc, name)(**kw),
                       _calib_batches(3, binary), _pair)
    assert tm.n_bins == jm.n_bins and tm._defaults["acc_sum"].dtype == torch.float32
    _states_equal(tm, jm, float_rtol={"conf_sum": RTOL})
    _close(tm.compute(), jm.compute())


def test_calibration_sketch_at_n_bins_grid_is_the_exact_grid():
    """``approx_error = 1 / n_bins`` gives the exact path's grid: the same value (JAX's bit-exact property)."""
    batches = _calib_batches(4, False)
    sketch = tc.MulticlassCalibrationError(num_classes=C, approx="sketch", approx_error=1 / 15, **CPU)
    exact = tc.MulticlassCalibrationError(num_classes=C, n_bins=15, **CPU)
    for p, t in batches:
        sketch.update(torch.from_numpy(p), torch.from_numpy(t))
        exact.update(torch.from_numpy(p), torch.from_numpy(t))
    assert float(sketch.compute()) == float(exact.compute())


def test_curve_sketch_dispatches_on_the_device_alone(monkeypatch):
    """Scores that require grad go to the kernel on a non-CPU state, detached (the histogram has no gradient), and
    give the detached scores' histogram on the CPU."""
    from torchmetrics_tpu_torch.classification import precision_recall_curve as prc
    from torchmetrics_tpu_torch.sketches import QuantileSketch

    sketch, rng = QuantileSketch(20), np.random.default_rng(7)
    scores = torch.from_numpy(rng.random((6, 3)).astype(np.float32))
    target = torch.from_numpy(rng.integers(0, 3, 6).astype(np.int32))
    weights = torch.ones(6)
    seen = []
    monkeypatch.setattr(prc, "quantile_hist", lambda hist, p, t, w, s: seen.append(p.requires_grad) or hist)
    prc._sketch_accumulate(sketch.init((3, 2)).to("meta"), scores.to("meta").requires_grad_(), target.to("meta"),
                           weights.to("meta"), sketch)
    assert seen == [False]
    got = prc._sketch_accumulate(sketch.init((3, 2)), scores.clone().requires_grad_(), target, weights, sketch)
    want = prc._sketch_accumulate(sketch.init((3, 2)), scores, target, weights, sketch)
    assert not got.requires_grad and torch.equal(got, want)


# ------------------------------------------------------------------ mAP
@pytest.mark.parametrize("backend", ["native", "native_numpy"])
@pytest.mark.parametrize(("average", "class_metrics"), [("macro", False), ("macro", True), ("micro", False)])
def test_map_sketch_matches_jax(average, class_metrics, backend):
    from torchmetrics_tpu.detection import MeanAveragePrecision as JMAP

    kw = {"approx": "sketch", "average": average, "class_metrics": class_metrics, "sketch_classes": 10}
    tm, jm = _run_both(lambda: MeanAveragePrecision(backend=backend, **kw, **CPU), lambda: JMAP(**kw),
                       _map_batches(21), _pair)
    _states_equal(tm, jm)
    got, want = tm.compute(), jm.compute()
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key])
    assert tm._gather_approx_provenance() == pytest.approx(jm._gather_approx_provenance())


def _crowded_map_batches(seed):
    """Many detections of one class an image (past small maxDets caps), tied scores, user areas (some 0, so
    derived, and some past the "all" range), crowds, and images without detections or without ground truths."""
    rng = np.random.default_rng(seed)
    out = []
    for n_img in (4, 1, 3):
        preds, target = [], []
        for i in range(n_img):
            g = int(rng.integers(0, 9)) if i else 0
            gt = _boxes(rng, g)
            d = int(rng.integers(0, 30)) if i != 1 else 0
            det = gt[rng.integers(0, g, d)] + rng.normal(0, 3, (d, 4)) if g else _boxes(rng, d)
            area = rng.choice([0.0, 900.0, 2e10], g).astype(np.float32)
            target.append({"boxes": gt, "labels": rng.integers(0, 3, g),
                           "iscrowd": (rng.random(g) < 0.15).astype(np.int64), "area": area})
            preds.append({"boxes": det.astype(np.float32), "labels": rng.integers(0, 3, d),
                          "scores": rng.choice([0.25, 0.5, 0.75, 0.9], d).astype(np.float32)})
        out.append((preds, target))
    return out


@pytest.mark.parametrize("chunk", [2, 1024])
def test_map_sketch_device_path_matches_the_oracle_past_the_caps(monkeypatch, chunk):
    """The matcher path (chunks of ``chunk`` items) equals the host ``_evaluate_image`` path and JAX bit for bit on
    the state, with maxDets caps that cut each item's detections."""
    import torchmetrics_tpu_torch.detection.mean_ap as port_map
    from torchmetrics_tpu.detection import MeanAveragePrecision as JMAP

    monkeypatch.setattr(port_map, "_CHUNK", chunk)
    kw = {"approx": "sketch", "sketch_classes": 4, "max_detection_thresholds": [1, 3, 5]}
    batches = _crowded_map_batches(31)
    tm, jm = _run_both(lambda: MeanAveragePrecision(**kw, **CPU), lambda: JMAP(**kw), batches, _pair)
    oracle = MeanAveragePrecision(backend="native_numpy", **kw, **CPU)
    for batch in batches:
        oracle.update(*_pair(batch, _to_torch))
    _states_equal(tm, jm)
    for name, value in tm.metric_state.items():
        assert torch.equal(value, oracle.metric_state[name]), name
    assert float(tm.metric_state["det_total"].sum()) < sum(len(p["scores"]) for b in batches for p in b[0])
    _close(tm.compute()["map"], jm.compute()["map"])


def test_map_sketch_refusals_and_set_approx():
    from torchmetrics_tpu.detection import MeanAveragePrecision as JMAP

    for kw, match in (({"iou_type": "segm"}, "bbox"), ({"extended_summary": True}, "extended_summary"),
                      ({"sketch_classes": 0}, "sketch_classes")):
        with pytest.raises(ValueError, match=match):
            JMAP(approx="sketch", **kw)
        with pytest.raises(ValueError, match=match):
            MeanAveragePrecision(approx="sketch", **kw, **CPU)
    small = MeanAveragePrecision(approx="sketch", sketch_classes=3, **CPU)
    preds, target = _map_batches(22, sizes=(1,), classes=7)[0]
    target[0]["labels"][:] = 5
    with pytest.raises(ValueError, match="sketch_classes"):
        small.update(_to_torch(preds), _to_torch(target))
    # set_approx: the list states are dropped and the sketch leaves registered, as in JAX
    batches = _map_batches(23)
    tm, jm = MeanAveragePrecision(sketch_classes=10, **CPU), JMAP(sketch_classes=10)
    tm.update(*_pair(batches[0], _to_torch))
    jm.update(*_pair(batches[0], _to_jax))
    tm.set_approx("sketch")
    jm.set_approx("sketch")
    assert set(tm._defaults) == set(jm._defaults) == {"score_hist_tp", "score_hist_fp", "tp_count", "gt_total",
                                                      "det_total"}
    assert not tm.update_called
    for batch in batches[1:]:
        tm.update(*_pair(batch, _to_torch))
        jm.update(*_pair(batch, _to_jax))
    _states_equal(tm, jm)
    _close(tm.compute()["map"], jm.compute()["map"])
    tm.set_approx(None)
    assert "detection_boxes" in tm._defaults and "score_hist_tp" not in tm._defaults


# ------------------------------------------------------------------ DistinctNGrams
@pytest.mark.parametrize(("ngram", "ignore_index", "approx_error"), [(1, None, None), (2, -100, None),
                                                                      (3, -100, 0.1), (4, None, 0.008)])
def test_distinct_hll_matches_jax(ngram, ignore_index, approx_error):
    from torchmetrics_tpu.text import DistinctNGrams as JDistinct

    kw = {"ngram": ngram, "ignore_index": ignore_index, "approx": "sketch", "approx_error": approx_error}
    tm, jm = _run_both(lambda: tt.DistinctNGrams(**kw, **CPU), lambda: JDistinct(**kw), _token_batches(ngram),
                       lambda b, conv: (conv(b),))
    assert tm._hll.precision == jm._hll.precision
    _states_equal(tm, jm)
    _close(tm.compute(), jm.compute())


def test_distinct_hll_within_4_rse_of_exact():
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 5_000, (8, 1_024)).astype(np.int32)
    for ngram in (1, 2):
        sketch, exact = tt.DistinctNGrams(ngram, approx="sketch", **CPU), tt.DistinctNGrams(ngram, **CPU)
        sketch.update(torch.from_numpy(ids))
        exact.update(torch.from_numpy(ids))
        ratio = float(exact.compute())
        assert abs(float(sketch.compute()) - ratio) <= 4 * sketch._hll.relative_error * ratio


# ------------------------------------------------------------------ BLEU, SacreBLEU, ROUGE reservoirs
@pytest.mark.parametrize("name", ["BLEUScore", "SacreBLEUScore", "ROUGEScore"])
@pytest.mark.parametrize("sample_size", [4, 1024])
def test_reservoir_matches_jax(name, sample_size):
    from torchmetrics_tpu import text as jt

    kw = {"approx": "reservoir", "sample_size": sample_size}
    if name == "ROUGEScore":
        kw["rouge_keys"] = ("rouge1", "rougeL")
    tm, jm = _run_both(lambda: getattr(tt, name)(**kw, **CPU), lambda: getattr(jt, name)(**kw), _text_batches(31),
                       lambda b, conv: b)
    _states_equal(tm, jm)
    _close(tm.compute(), jm.compute())
    assert tm._gather_approx_provenance() == pytest.approx(jm._gather_approx_provenance())
    if sample_size == 1024:  # the corpus fits: ROUGE equals its exact path, the bound is 0
        assert tm._gather_approx_provenance()["bound"] == 0.0
        if name == "ROUGEScore":
            exact = tt.ROUGEScore(rouge_keys=kw["rouge_keys"], **CPU)
            for preds, target in _text_batches(31):
                exact.update(preds, target)
            _close(tm.compute(), exact.compute(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["BLEUScore", "ROUGEScore"])
def test_text_set_approx_matches_jax(name):
    from torchmetrics_tpu import text as jt

    batches = _text_batches(32)
    tm, jm = getattr(tt, name)(sample_size=5, **CPU), getattr(jt, name)(sample_size=5)
    tm.update(*batches[0])
    jm.update(*batches[0])
    tm.set_approx("reservoir")
    jm.set_approx("reservoir")
    assert set(tm._defaults) == set(jm._defaults) == {"corpus_sample", "samples_total"} and not tm.update_called
    for batch in batches[1:]:
        tm.update(*batch)
        jm.update(*batch)
    _states_equal(tm, jm)
    _close(tm.compute(), jm.compute())
    tm.set_approx(None)
    jm.set_approx(None)
    assert set(tm._defaults) == set(jm._defaults) and tm._reservoir is None


# ------------------------------------------------------------------ the base class
def test_approx_kwargs_validated_as_jax():
    from torchmetrics_tpu.regression import MeanSquaredError as JMSE

    from torchmetrics_tpu_torch.regression import MeanSquaredError

    for kw, match in (({"approx": "montecarlo"}, "approx"), ({"approx_error": 0.01}, "approx_error"),
                      ({"approx": "sketch", "approx_error": 0.7}, "approx_error"),
                      ({"approx": "sketch", "approx_error": 0.0}, "approx_error")):
        with pytest.raises(ValueError, match=match):
            JMSE(**kw)
        with pytest.raises(ValueError, match=match):
            MeanSquaredError(**kw, **CPU)
    with pytest.raises(ValueError, match="thresholds"):
        tc.BinaryAUROC(thresholds=50, approx="sketch", **CPU)
    # a metric with no sketch layout takes approx and computes exactly; set_approx on it raises JAX's error
    mse, plain = MeanSquaredError(approx="sketch", **CPU), MeanSquaredError(**CPU)
    for m in (mse, plain):
        m.update(torch.tensor([1.0, 2.0, 4.0]), torch.tensor([1.5, 2.0, 3.0]))
    assert float(mse.compute()) == float(plain.compute()) and mse.approx == "sketch"
    with pytest.raises(ValueError, match="_install_approx_states"):
        mse.set_approx(None)
    for kw, match in (({"sample_size": 0}, "sample_size"), ({"sample_size": 2.5}, "sample_size")):
        with pytest.raises(ValueError, match=match):
            tt.ROUGEScore(approx="reservoir", **kw, **CPU)
        with pytest.raises(ValueError, match=match):
            tt.BLEUScore(approx="reservoir", **kw, **CPU)


@pytest.mark.parametrize("which", ["curve", "calibration", "distinct", "bleu", "rouge", "map"])
def test_jax_sketch_state_carries_into_the_port(which):
    """``convert.state_from_jax`` takes every sketch leaf: the carried state computes the JAX value."""
    from torchmetrics_tpu import classification as jc
    from torchmetrics_tpu import text as jt
    from torchmetrics_tpu.detection import MeanAveragePrecision as JMAP

    from torchmetrics_tpu_torch.convert import state_from_jax

    make = {
        "curve": (lambda: jc.MulticlassAUROC(num_classes=C, approx="sketch"),
                  lambda: tc.MulticlassAUROC(num_classes=C, approx="sketch", **CPU), _curve_batches(41, "multiclass"),
                  _pair),
        "calibration": (lambda: jc.BinaryCalibrationError(approx="sketch"),
                        lambda: tc.BinaryCalibrationError(approx="sketch", **CPU), _calib_batches(42, True), _pair),
        "distinct": (lambda: jt.DistinctNGrams(2, approx="sketch"), lambda: tt.DistinctNGrams(2, approx="sketch", **CPU),
                     _token_batches(43), lambda b, conv: (conv(b),)),
        "bleu": (lambda: jt.BLEUScore(approx="reservoir", sample_size=4),
                 lambda: tt.BLEUScore(approx="reservoir", sample_size=4, **CPU), _text_batches(44), lambda b, c: b),
        "rouge": (lambda: jt.ROUGEScore(approx="reservoir", sample_size=4),
                  lambda: tt.ROUGEScore(approx="reservoir", sample_size=4, **CPU), _text_batches(45), lambda b, c: b),
        "map": (lambda: JMAP(approx="sketch", sketch_classes=10),
                lambda: MeanAveragePrecision(approx="sketch", sketch_classes=10, **CPU), _map_batches(46), _pair),
    }[which]
    jm, tm = make[0](), make[1]()
    for batch in make[2]:
        jm.update(*make[3](batch, _to_jax))
    carried = state_from_jax(tm, {k: np.asarray(v) for k, v in jm.metric_state.items()})
    _close(tm.compute_state(carried), jm.compute())


# ------------------------------------------------------------------ the gloo world
def _world_metrics():
    """The sketch-mode metrics every rank syncs, built on the CPU."""
    return {
        "auroc": tc.MulticlassAUROC(num_classes=C, approx="sketch", **CPU),
        "calibration": tc.MulticlassCalibrationError(num_classes=C, approx="sketch", **CPU),
        "distinct": tt.DistinctNGrams(2, ignore_index=-100, approx="sketch", **CPU),
        "bleu": tt.BLEUScore(approx="reservoir", sample_size=8, **CPU),
        "rouge": tt.ROUGEScore(rouge_keys=("rouge1",), approx="reservoir", sample_size=8, **CPU),
        "map": MeanAveragePrecision(approx="sketch", sketch_classes=10, **CPU),
    }


def _world_batches(rank):
    """Rank ``rank``'s shard of every metric's stream (the one-process run takes all shards in rank order)."""
    return {
        "auroc": _curve_batches(100 + rank, "multiclass", sizes=(30, 17)),
        "calibration": _calib_batches(200 + rank, False, sizes=(25, 0)),
        "distinct": _token_batches(300 + rank),
        "bleu": _text_batches(400 + rank, sizes=(5, 4)),
        "rouge": _text_batches(500 + rank, sizes=(4, 3)),
        "map": _map_batches(600 + rank, sizes=(2, 1)),
    }


def _args(name, batch):
    if name in ("bleu", "rouge"):
        return batch
    if name == "distinct":
        return (torch.from_numpy(batch),)
    return _pair(batch, _to_torch)


def _fold(metric, name, batches, state=None):
    state = metric.init_state() if state is None else state
    for batch in batches:
        state = metric.update_state(state, *_args(name, batch))
    return state


def _rank_checks(rank, world, inputs):
    metrics = _world_metrics()
    states = {name: _fold(m, name, _world_batches(rank)[name]) for name, m in metrics.items()}
    out = {"per_metric": {}, "collectives": {}}
    for name, metric in metrics.items():
        before = Counter(COLLECTIVES)
        out["per_metric"][name] = metric.sync_states(states[name])
        out["collectives"][name] = dict(Counter(COLLECTIVES) - before)
    col = MetricCollection(metrics, compute_groups=False)
    before = Counter(COLLECTIVES)
    out["collection"] = col.sync_states(states)
    out["collection_collectives"] = dict(Counter(COLLECTIVES) - before)
    plan = plan_for_metrics(list(metrics.values()), [states[n] for n in metrics])
    out["plan"] = {"buckets": [(b.dtype, b.op, [s.name for s in b.slots]) for b in plan.buckets],
                   "passthrough": [name for _, name, _ in plan.passthrough],
                   "n_collectives": plan.n_collectives, "n_shape_exchanges": plan.n_shape_exchanges}
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    results = run_world(__file__, {}, tmp_path_factory.mktemp("sketch_world"), WORLD)
    metrics = _world_metrics()
    one = {name: _fold(m, name, [b for r in range(WORLD) for b in _world_batches(r)[name]])
           for name, m in metrics.items()}
    return results, one


def _assert_state_equal(got, want, name):
    """Equal leaves; calibration's ``conf_sum`` (sums of confidences, not counts) within 1e-6 relative."""
    assert set(got) == set(want), name
    for leaf, w in want.items():
        assert got[leaf].dtype == w.dtype, (name, leaf)
        if leaf == "conf_sum":
            np.testing.assert_allclose(got[leaf].numpy(), w.numpy(), rtol=RTOL, err_msg=name)
        else:
            assert torch.equal(got[leaf], w), (name, leaf)


@pytest.mark.parametrize("name", ["auroc", "calibration", "distinct", "bleu", "rouge", "map"])
def test_synced_sketch_states_equal_the_one_process_state(world, name):
    results, one = world
    want = dict(one[name])
    want["_n"] = torch.tensor(2 * WORLD if name != "distinct" else 3 * WORLD, dtype=torch.int32)
    for r in results:
        _assert_state_equal(r["per_metric"][name], want, name)
        _assert_state_equal(r["collection"][name], want, name)


def test_sketch_leaves_ride_the_planner_buckets(world):
    results, _ = world
    by_kind = {"sum": ("score_hist", "conf_sum", "acc_sum", "count", "score_hist_tp", "score_hist_fp"),
               "max": ("registers",)}
    for r in results:
        plan = r["plan"]
        placed = {op: [n for dt, o, names in plan["buckets"] if o == op for n in names] for op in ("sum", "max")}
        for op, names in by_kind.items():
            assert set(names) <= set(placed[op]), (op, placed)
        # the reservoirs sync by one fixed-shape gather each, and nothing exchanges shapes
        assert sorted(plan["passthrough"]) == ["corpus_sample", "corpus_sample"]
        assert plan["n_shape_exchanges"] == 0
        assert plan["n_collectives"] == len(plan["buckets"]) + 2
        # one sketch-mode metric: one all_reduce a (dtype, op) bucket; a reservoir adds one all_gather
        assert r["collectives"]["auroc"] == {"all_reduce": 2}  # float32 sum (the histogram), int32 sum (_n)
        assert r["collectives"]["distinct"] == {"all_reduce": 3}  # int32 max, float32 sum, int32 sum
        assert r["collectives"]["bleu"] == {"all_reduce": 1, "all_gather": 1}  # int32 sum, the reservoir
        assert r["collection_collectives"] == {"all_reduce": len(plan["buckets"]), "all_gather": 2}


if __name__ == "__main__":
    worker_main(_rank_checks)
