"""Parity of the port's binary and multilabel curve family, and the exact AUROC, with the JAX package.

The same seeded numpy inputs go through both packages; the port runs on the
CPU, where the binned updates are the plain versions of the
``binned_confmat_multilabel`` and ``binned_confmat_multiclass`` kernels
(``chip_smoke.py`` holds the kernels against them on the card). Binned
confusion states are counts and must be exactly equal. Curves, areas and
averages are float32 reductions taken in another order than XLA's: within
``ATOL = 1e-6``, NaN thresholds in the same places.

Inputs cover ties (scores on a 0.1 grid), NaN scores, ``-0.0`` beside
``+0.0``, ``ignore_index``, logits (the whole-batch sigmoid), a label with
no positives, unsorted and duplicate thresholds, and ``max_fpr``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu_torch.convert import state_from_jax

jfp = importlib.import_module("torchmetrics_tpu.functional.classification.precision_recall_curve")
tfp = importlib.import_module("torchmetrics_tpu_torch.functional.classification.precision_recall_curve")
jfr = importlib.import_module("torchmetrics_tpu.functional.classification.roc")
tfr = importlib.import_module("torchmetrics_tpu_torch.functional.classification.roc")
jfa = importlib.import_module("torchmetrics_tpu.functional.classification.auroc")
tfa = importlib.import_module("torchmetrics_tpu_torch.functional.classification.auroc")
jfap = importlib.import_module("torchmetrics_tpu.functional.classification.average_precision")
tfap = importlib.import_module("torchmetrics_tpu_torch.functional.classification.average_precision")

ATOL = 1e-6
N, C, L = 64, 5, 4
THRESHOLDS = [None, 7, [0.9, 0.1, 0.5, 0.5, 0.3, 0.05]]  # exact, a grid, unsorted with a duplicate
THR_IDS = ["exact", "grid7", "unsorted-dup"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(got, want):
    """Recursive over tuples and lists; counts exactly, floats within ATOL, NaNs in place."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    if np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
    else:
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def _binary(seed, n=N, logits=False, edits=()):
    rng = np.random.default_rng(seed)
    p = np.round(rng.uniform(size=n), 1).astype(np.float32)  # ties
    t = rng.integers(0, 2, n).astype(np.int64)
    if logits:
        p = (4 * p - 2).astype(np.float32)
    if "nan" in edits:
        p[::9] = np.nan
    if "signed_zero" in edits:
        p[1::7], p[2::7] = -0.0, 0.0
    if "ignore" in edits:
        t[::5] = -1
    return p, t


def _multilabel(seed, n=N, logits=False, edits=()):
    rng = np.random.default_rng(seed)
    p = np.round(rng.uniform(size=(n, L)), 1).astype(np.float32)
    t = (rng.uniform(size=(n, L)) < 0.35).astype(np.int64)
    t[:, 2] = 0  # a label with no positives
    if logits:
        p = (4 * p - 2).astype(np.float32)
    if "nan" in edits:
        p[::9, 1] = np.nan
    if "signed_zero" in edits:
        p[1::7, 0], p[2::7, 0] = -0.0, 0.0
    if "ignore" in edits:
        t[::5, 3] = -1
    return p, t


def _multiclass(seed, n=N, logits=False, edits=()):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(C), size=n).astype(np.float32)
    p = np.round(p, 1).astype(np.float32)  # ties
    t = rng.integers(0, C, n).astype(np.int64)
    if logits:
        p = (3 * rng.normal(size=(n, C))).astype(np.float32)
    if "ignore" in edits:
        t[::5] = -1
    return p, t


DATA = {"binary": _binary, "multiclass": _multiclass, "multilabel": _multilabel}
SIZE = {"binary": {}, "multiclass": {"num_classes": C}, "multilabel": {"num_labels": L}}
EDITS = [((), False), (("nan", "signed_zero"), False), (("ignore",), False), ((), True)]
EDIT_IDS = ["plain", "nan-signed-zero", "ignore", "logits"]


def _inputs(task, seed, edits, logits):
    if task == "multiclass":
        edits = tuple(e for e in edits if e == "ignore")
    p, t = DATA[task](seed, logits=logits, edits=edits)
    ignore_index = -1 if "ignore" in edits else None
    return p, t, ignore_index


# ------------------------------------------------------------------ tie and NaN order
def test_stable_sort_puts_nan_last_and_ties_signed_zeros():
    preds = torch.tensor([0.3, float("nan"), -0.0, 0.7, 0.0, float("nan"), 0.3])
    _, order = torch.sort(-preds, stable=True)
    want = np.argsort(-np.asarray(jnp.asarray(preds.numpy())), kind="stable")
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jnp.argsort(-jnp.asarray(preds.numpy()), stable=True)))
    assert order.tolist()[-2:] == [1, 5]  # NaNs last, in their order
    assert order.tolist().index(2) < order.tolist().index(4)  # -0.0 ties with +0.0: input order kept


@pytest.mark.parametrize(("edits", "logits"), EDITS, ids=EDIT_IDS)
def test_binary_clf_curve_tie_collapse(edits, logits):
    p, t = _binary(3, edits=edits, logits=logits)
    w = np.ones(N, np.float32)
    want = jfp._binary_clf_curve(jnp.asarray(p), jnp.asarray(t), jnp.asarray(w))
    got = tfp._binary_clf_curve(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(w))
    _assert_close(got, want)


# ------------------------------------------------------------------ formatting
@pytest.mark.parametrize("logits", [False, True])
@pytest.mark.parametrize("task", ["binary", "multilabel"])
def test_prc_format_parity(task, logits):
    p, t, ignore_index = _inputs(task, 5, ("ignore",), logits)
    if task == "binary":
        want = jfp._binary_prc_format(jnp.asarray(p), jnp.asarray(t), ignore_index)
        got = tfp._binary_prc_format(torch.from_numpy(p), torch.from_numpy(t), ignore_index)
    else:
        want = jfp._multilabel_prc_format(jnp.asarray(p), jnp.asarray(t), L, ignore_index)
        got = tfp._multilabel_prc_format(torch.from_numpy(p), torch.from_numpy(t), L, ignore_index)
    assert [g.dtype for g in got] == [torch.float32, torch.int32, torch.float32]
    _assert_close(got, want)


# ------------------------------------------------------------------ functional
FUNCTIONS = ["precision_recall_curve", "roc", "auroc", "average_precision"]
MODULES = {"precision_recall_curve": (jfp, tfp), "roc": (jfr, tfr), "auroc": (jfa, tfa), "average_precision": (jfap, tfap)}


@pytest.mark.parametrize(("edits", "logits"), EDITS, ids=EDIT_IDS)
@pytest.mark.parametrize("thresholds", THRESHOLDS, ids=THR_IDS)
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("fn", FUNCTIONS)
def test_functional_parity(fn, task, thresholds, edits, logits):
    p, t, ignore_index = _inputs(task, 11, edits, logits)
    jm, tm = MODULES[fn]
    name = f"{task}_{fn}"
    want = getattr(jm, name)(jnp.asarray(p), jnp.asarray(t), **SIZE[task], thresholds=thresholds,
                             ignore_index=ignore_index)
    got = getattr(tm, name)(torch.from_numpy(p), torch.from_numpy(t), **SIZE[task], thresholds=thresholds,
                            ignore_index=ignore_index)
    _assert_close(got, want)


# the multiclass task has no micro average
AVERAGES = [(task, a) for task in ("multiclass", "multilabel") for a in ("macro", "weighted", "none", "micro")
            if not (task == "multiclass" and a == "micro")]


@pytest.mark.parametrize("thresholds", THRESHOLDS, ids=THR_IDS)
@pytest.mark.parametrize("fn", ["auroc", "average_precision"])
@pytest.mark.parametrize(("task", "average"), AVERAGES)
def test_functional_averages(task, average, fn, thresholds):
    p, t, _ = _inputs(task, 13, (), False)
    jm, tm = MODULES[fn]
    want = getattr(jm, f"{task}_{fn}")(jnp.asarray(p), jnp.asarray(t), **SIZE[task], average=average,
                                       thresholds=thresholds)
    got = getattr(tm, f"{task}_{fn}")(torch.from_numpy(p), torch.from_numpy(t), **SIZE[task], average=average,
                                      thresholds=thresholds)
    _assert_close(got, want)


@pytest.mark.parametrize("max_fpr", [0.05, 0.3, 0.5, 1.0])
@pytest.mark.parametrize("thresholds", [None, 50], ids=["exact", "grid50"])
@pytest.mark.parametrize(("edits", "logits"), EDITS[:3], ids=EDIT_IDS[:3])
def test_binary_auroc_max_fpr(max_fpr, thresholds, edits, logits):
    p, t = _binary(17, n=200, edits=edits, logits=logits)
    p = np.where(np.isnan(p), p, p + np.random.default_rng(1).uniform(0, 0.09, p.shape)).astype(np.float32)
    ignore_index = -1 if "ignore" in edits else None
    want = jfa.binary_auroc(jnp.asarray(p), jnp.asarray(t), max_fpr=max_fpr, thresholds=thresholds,
                            ignore_index=ignore_index)
    got = tfa.binary_auroc(torch.from_numpy(p), torch.from_numpy(t), max_fpr=max_fpr, thresholds=thresholds,
                           ignore_index=ignore_index)
    _assert_close(got, want)


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_functional_task_dispatch(fn, task):
    p, t, _ = _inputs(task, 19, (), False)
    jm, tm = MODULES[fn]
    want = getattr(jm, fn)(jnp.asarray(p), jnp.asarray(t), task, thresholds=9, **SIZE[task])
    got = getattr(tm, fn)(torch.from_numpy(p), torch.from_numpy(t), task, thresholds=9, **SIZE[task])
    _assert_close(got, want)
    with pytest.raises(ValueError):
        getattr(tm, fn)(torch.from_numpy(p), torch.from_numpy(t), "ranking")


def test_binary_auroc_validates_max_fpr():
    p, t = _binary(2)
    for bad in (0.0, 1.5, 1):
        with pytest.raises(ValueError, match="max_fpr"):
            tfa.binary_auroc(torch.from_numpy(p), torch.from_numpy(t), max_fpr=bad)


# ------------------------------------------------------------------ modular
CLASSES = ["PrecisionRecallCurve", "ROC", "AUROC", "AveragePrecision"]


@pytest.mark.parametrize(("edits", "logits"), EDITS, ids=EDIT_IDS)
@pytest.mark.parametrize("thresholds", THRESHOLDS, ids=THR_IDS)
@pytest.mark.parametrize("task", ["Binary", "Multiclass", "Multilabel"])
@pytest.mark.parametrize("name", CLASSES)
def test_metric_multi_batch_parity(name, task, thresholds, edits, logits):
    jm = getattr(jc, f"{task}{name}")
    tm = getattr(tc, f"{task}{name}")
    task_l = task.lower()
    ignore_index = -1 if "ignore" in edits else None
    kw = {**SIZE[task_l], "thresholds": thresholds, "ignore_index": ignore_index}
    jmetric, tmetric = jm(**kw), tm(**kw, device="cpu")
    for seed in range(3):
        p, t, _ = _inputs(task_l, 30 + seed, edits, logits)
        jmetric.update(jnp.asarray(p), jnp.asarray(t))
        tmetric.update(torch.from_numpy(p), torch.from_numpy(t))
    if thresholds is not None:
        _assert_close(tmetric.metric_state["confmat"], jmetric.metric_state["confmat"])
        assert tmetric.metric_state["confmat"].dtype == torch.int32
    _assert_close(tmetric.compute(), jmetric.compute())


@pytest.mark.parametrize("thresholds", THRESHOLDS, ids=THR_IDS)
@pytest.mark.parametrize("name", ["AUROC", "AveragePrecision"])
@pytest.mark.parametrize(("task", "average"), [(t.capitalize(), a) for t, a in AVERAGES])
def test_metric_averages(task, average, name, thresholds):
    kw = {**SIZE[task.lower()], "thresholds": thresholds, "average": average}
    jmetric, tmetric = getattr(jc, f"{task}{name}")(**kw), getattr(tc, f"{task}{name}")(**kw, device="cpu")
    for seed in range(2):
        p, t, _ = _inputs(task.lower(), 40 + seed, (), False)
        jmetric.update(jnp.asarray(p), jnp.asarray(t))
        tmetric.update(torch.from_numpy(p), torch.from_numpy(t))
    _assert_close(tmetric.compute(), jmetric.compute())


@pytest.mark.parametrize("max_fpr", [0.05, 0.5])
def test_binary_auroc_metric_max_fpr(max_fpr):
    jmetric = jc.BinaryAUROC(max_fpr=max_fpr)
    tmetric = tc.BinaryAUROC(max_fpr=max_fpr, device="cpu")
    for seed in range(3):
        p, t = _binary(50 + seed, n=100)
        jmetric.update(jnp.asarray(p), jnp.asarray(t))
        tmetric.update(torch.from_numpy(p), torch.from_numpy(t))
    _assert_close(tmetric.compute(), jmetric.compute())
    binned = tc.BinaryAUROC(max_fpr=max_fpr, thresholds=10, device="cpu")
    binned.update(torch.from_numpy(p), torch.from_numpy(t))
    with pytest.raises(NotImplementedError, match="max_fpr"):
        binned.compute()


# ------------------------------------------------------------------ task wrappers
WRAPPED = {
    "PrecisionRecallCurve": ("BinaryPrecisionRecallCurve", "MulticlassPrecisionRecallCurve",
                             "MultilabelPrecisionRecallCurve"),
    "ROC": ("BinaryROC", "MulticlassROC", "MultilabelROC"),
    "AUROC": ("BinaryAUROC", "MulticlassAUROC", "MultilabelAUROC"),
    "AveragePrecision": ("BinaryAveragePrecision", "MulticlassAveragePrecision", "MultilabelAveragePrecision"),
}


@pytest.mark.parametrize("name", CLASSES)
def test_task_wrappers_build_the_jax_classes(name):
    kw = {"num_classes": C, "num_labels": L, "thresholds": 5}
    if name in ("AUROC", "AveragePrecision"):
        kw["average"] = "macro"
    if name == "AUROC":
        kw["max_fpr"] = None
    for task, cls in zip(("binary", "multiclass", "multilabel"), WRAPPED[name]):
        j = getattr(jc, name)(task=task, **kw)
        t = getattr(tc, name)(task=task, **kw, device="cpu")
        assert type(j).__name__ == type(t).__name__ == cls
        assert t._defaults["confmat"].shape == j._defaults["confmat"].shape
    with pytest.raises(ValueError, match="not supported"):
        getattr(tc, name)(task="ranking", device="cpu")


# ------------------------------------------------------------------ state carried from JAX
@pytest.mark.parametrize("thresholds", [None, 7], ids=["exact", "binned"])
@pytest.mark.parametrize("task", ["Binary", "Multiclass", "Multilabel"])
@pytest.mark.parametrize("name", ["ROC", "AUROC", "AveragePrecision"])
def test_state_from_jax_round_trip(name, task, thresholds):
    jmetric = getattr(jc, f"{task}{name}")(**SIZE[task.lower()], thresholds=thresholds)
    tmetric = getattr(tc, f"{task}{name}")(**SIZE[task.lower()], thresholds=thresholds, device="cpu")
    state = jmetric.init_state()
    for seed in range(2):
        p, t, _ = _inputs(task.lower(), 60 + seed, (), False)
        state = jmetric.update_state(state, jnp.asarray(p), jnp.asarray(t))
    np_state = {k: (list(map(np.asarray, v)) if isinstance(v, tuple) else np.asarray(v)) for k, v in state.items()}
    carried = state_from_jax(tmetric, np_state)
    if thresholds is None:
        assert all(len(carried[k]) == 2 for k in ("preds", "target", "weight"))
    else:
        assert carried["confmat"].dtype == torch.int32
    _assert_close(tmetric.compute_state(carried), jmetric.compute_state(state))
