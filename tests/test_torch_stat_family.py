"""Parity of the port's stat-scores family for the three tasks with the JAX package.

Precision, recall, specificity, NPV, hamming, accuracy and F-beta, functional
and modular, binary, multiclass and multilabel. Inputs are made from a seed
with numpy and fed to both packages; the port runs on the CPU. Stat scores and
integer states are sums of 0/1 indicators and must be exactly equal; scores
are float32 reductions taken in another order than XLA's: ``rtol=1e-6,
atol=1e-7``. Logits (scores outside [0, 1]) exercise the sigmoid that the
whole tensor takes when any of its elements lies outside [0, 1].
"""

import importlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu_torch.convert import state_from_jax

jfam = importlib.import_module("torchmetrics_tpu.functional.classification._family")
tfam = importlib.import_module("torchmetrics_tpu_torch.functional.classification._family")
jss = importlib.import_module("torchmetrics_tpu.functional.classification.stat_scores")
tss = importlib.import_module("torchmetrics_tpu_torch.functional.classification.stat_scores")

RTOL, ATOL = 1e-6, 1e-7
C, L, N = 5, 4, 64
KINDS = ["precision", "recall", "specificity", "npv", "hamming", "accuracy", "fbeta"]
AVERAGES = ["micro", "macro", "weighted", "none"]
CPU = {"device": "cpu"}

# (functional module, binary function, task dispatcher) of each kind, both packages
PUBLIC = {
    "precision": ("precision_recall", "binary_precision", "precision"),
    "recall": ("precision_recall", "binary_recall", "recall"),
    "specificity": ("specificity", "binary_specificity", "specificity"),
    "npv": ("negative_predictive_value", "binary_negative_predictive_value", "negative_predictive_value"),
    "hamming": ("hamming", "binary_hamming_distance", "hamming_distance"),
    "accuracy": ("accuracy", "binary_accuracy", "accuracy"),
    "fbeta": ("f_beta", "binary_f1_score", "f1_score"),
}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def _batch(task, seed, logits=False, ignore_index=None, spatial=()):
    rng = np.random.default_rng(seed)
    if task == "multiclass":
        scores = rng.normal(size=(N, C, *spatial)).astype(np.float32)
        if not logits:
            scores = np.exp(scores) / np.exp(scores).sum(1, keepdims=True)
        target = rng.integers(0, C, size=(N, *spatial)).astype(np.int32)
    else:
        shape = (N, *spatial) if task == "binary" else (N, L, *spatial)
        scores = rng.normal(size=shape).astype(np.float32)
        if not logits:
            scores = 1 / (1 + np.exp(-scores))
        target = rng.integers(0, 2, size=shape).astype(np.int32)
    if ignore_index is not None:
        target[rng.random(target.shape) < 0.2] = ignore_index
    return scores.astype(np.float32), target


def _call(pkg_fam, kind, task, preds, target, average, multidim_average, ignore_index):
    if task == "binary":
        return pkg_fam._binary_stat_metric(kind, preds, target, 0.5, multidim_average, ignore_index, beta=0.5)
    if task == "multiclass":
        return pkg_fam._multiclass_stat_metric(kind, preds, target, C, average, 1, multidim_average, ignore_index,
                                               beta=0.5)
    return pkg_fam._multilabel_stat_metric(kind, preds, target, L, 0.5, average, multidim_average, ignore_index,
                                           beta=0.5)


# binary has no average: one case a task and average, "micro" standing for none
TASK_AVERAGES = [("binary", "micro")] + [(task, a) for task in ("multiclass", "multilabel") for a in AVERAGES]


@pytest.mark.parametrize("case", ["probs", "logits", "ignore", "samplewise", "samplewise_ignore"])
@pytest.mark.parametrize("task,average", TASK_AVERAGES, ids=[f"{t}-{a}" for t, a in TASK_AVERAGES])
@pytest.mark.parametrize("kind", KINDS)
def test_family_parity(kind, task, average, case):
    ignore_index = -1 if "ignore" in case else None
    multidim_average = "samplewise" if "samplewise" in case else "global"
    spatial = (3,) if multidim_average == "samplewise" else ()
    preds, target = _batch(task, seed=KINDS.index(kind), logits=case == "logits", ignore_index=ignore_index,
                           spatial=spatial)
    (jp, jt), (tp, tt) = _both(preds, target)
    want = _call(jfam, kind, task, jp, jt, average, multidim_average, ignore_index)
    got = _call(tfam, kind, task, tp, tt, average, multidim_average, ignore_index)
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("kind", KINDS)
def test_public_functions_and_dispatch(kind, task):
    module, binary_fn, dispatch = PUBLIC[kind]
    jm = importlib.import_module(f"torchmetrics_tpu.functional.classification.{module}")
    tm = importlib.import_module(f"torchmetrics_tpu_torch.functional.classification.{module}")
    preds, target = _batch(task, seed=40 + KINDS.index(kind), logits=True)
    (jp, jt), (tp, tt) = _both(preds, target)
    kw = {"num_classes": C, "num_labels": L, "average": "macro"}
    _close(getattr(tm, dispatch)(tp, tt, task, **kw), getattr(jm, dispatch)(jp, jt, task, **kw))
    if task == "binary":
        _close(getattr(tm, binary_fn)(tp, tt), getattr(jm, binary_fn)(jp, jt))


@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("task,average", TASK_AVERAGES, ids=[f"{t}-{a}" for t, a in TASK_AVERAGES])
def test_stat_scores_dispatch_parity(task, average, multidim_average):
    preds, target = _batch(task, seed=50, logits=True, spatial=(3,) if multidim_average == "samplewise" else ())
    (jp, jt), (tp, tt) = _both(preds, target)
    kw = {"num_classes": C, "num_labels": L, "average": average, "multidim_average": multidim_average,
          "ignore_index": -1}
    want, got = jss.stat_scores(jp, jt, task, **kw), tss.stat_scores(tp, tt, task, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), _np(want))


def test_sigmoid_predicate_is_whole_tensor():
    # one logit outside [0, 1] sends every score of the batch through the sigmoid
    preds = np.asarray([0.2, 0.6, 0.7, 1.5], dtype=np.float32)
    target = np.asarray([0, 1, 0, 1], dtype=np.int32)
    (jp, jt), (tp, tt) = _both(preds, target)
    got = tss.binary_stat_scores(tp, tt)
    np.testing.assert_array_equal(_np(got), _np(jss.binary_stat_scores(jp, jt)))
    assert got.tolist() == [2, 2, 0, 0, 2]  # sigmoid(0.2) > 0.5: all four predicted positive


def _state_np(state):
    return {k: ([np.asarray(x) for x in v] if isinstance(v, tuple) else np.asarray(v)) for k, v in state.items()}


def _assert_states_equal(torch_state, jax_state):
    want = _state_np(jax_state)
    assert set(torch_state) == set(want)
    for k, w in want.items():
        g = torch_state[k]
        if isinstance(w, list):
            assert len(g) == len(w), k
            for gi, wi in zip(g, w):
                assert _np(gi).dtype == wi.dtype, k
                np.testing.assert_array_equal(_np(gi), wi)
        else:
            assert _np(g).dtype == w.dtype, k
            np.testing.assert_array_equal(_np(g), w)


CLASS_KINDS = ["Precision", "Recall", "Specificity", "NegativePredictiveValue", "HammingDistance", "Accuracy",
               "F1Score", "StatScores"]


def _task_kwargs(task, average, multidim_average, ignore_index):
    kw = {"multidim_average": multidim_average, "ignore_index": ignore_index}
    if task == "multiclass":
        kw.update(num_classes=C, average=average)
    elif task == "multilabel":
        kw.update(num_labels=L, average=average)
    return kw


@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("name", CLASS_KINDS)
def test_metric_multi_batch_parity(name, task, multidim_average):
    cls_name = f"{task.capitalize()}{name}"
    kw = _task_kwargs(task, "weighted", multidim_average, -1)
    jm, tm = getattr(jc, cls_name)(**kw), getattr(tc, cls_name)(**kw, **CPU)
    spatial = (3,) if multidim_average == "samplewise" else ()
    for seed in range(3):
        (jp, jt), (tp, tt) = _both(*_batch(task, seed, logits=seed == 1, ignore_index=-1, spatial=spatial))
        jm.update(jp, jt)
        tm.update(tp, tt)
    _assert_states_equal(tm.metric_state, jm.metric_state)
    want, got = jm.compute(), tm.compute()
    if got.dtype == torch.int32:
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        _close(got, want)


@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("task", ["binary", "multilabel"])
def test_state_from_jax_round_trip(task, multidim_average):
    kw = _task_kwargs(task, "macro", multidim_average, None)
    cls_name = f"{task.capitalize()}FBetaScore"
    jm, tm = getattr(jc, cls_name)(beta=2.0, **kw), getattr(tc, cls_name)(beta=2.0, **kw, **CPU)
    state = jm.init_state()
    for seed in range(2):
        (jp, jt), _ = _both(*_batch(task, seed, spatial=(3,) if multidim_average == "samplewise" else ()))
        state = jm.update_state(state, jp, jt)
    loaded = state_from_jax(tm, _state_np(state))
    _assert_states_equal(loaded, state)
    _close(tm.compute_state(loaded), jm.compute_state(state))


WRAPPERS = ["Accuracy", "F1Score", "FBetaScore", "StatScores", "Precision", "Recall", "Specificity",
            "NegativePredictiveValue", "HammingDistance"]


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("name", WRAPPERS)
def test_task_wrappers_build_the_jax_classes(name, task):
    kw = {"num_classes": C, "num_labels": L, "average": "macro", "top_k": 1, "threshold": 0.5}
    if name == "FBetaScore":
        kw["beta"] = 2.0
    want = getattr(jc, name)(task=task, **kw)
    got = getattr(tc, name)(task=task, **kw, **CPU)
    assert type(got).__name__ == type(want).__name__
    (jp, jt), (tp, tt) = _both(*_batch(task, 60))
    jr, tr = want(jp, jt), got(tp, tt)
    if tr.dtype == torch.int32:
        np.testing.assert_array_equal(_np(tr), _np(jr))
    else:
        _close(tr, jr)
    with pytest.raises(ValueError, match="not supported"):
        getattr(tc, name)(task="regression", **CPU)


FACTORY = [("precision_recall", "Precision"), ("precision_recall", "Recall"), ("specificity", "Specificity"),
           ("negative_predictive_value", "NegativePredictiveValue"), ("hamming", "HammingDistance")]


@pytest.mark.parametrize("module,name", FACTORY, ids=[f[1] for f in FACTORY])
def test_factory_classes_pickle_with_their_module(module, name):
    for prefix in ("Binary", "Multiclass", "Multilabel", ""):
        cls = getattr(tc, prefix + name)
        assert cls.__module__ == f"torchmetrics_tpu_torch.classification.{module}"
        assert cls.__qualname__ == prefix + name
    metric = getattr(tc, f"Multilabel{name}")(num_labels=L, **CPU)
    (_, _), (tp, tt) = _both(*_batch("multilabel", 61))
    metric.update(tp, tt)
    clone = pickle.loads(pickle.dumps(metric))
    assert type(clone) is type(metric)
    assert torch.equal(clone.compute(), metric.compute())
    assert getattr(tc, name).__name__ == name and getattr(jc, name).__name__ == name


@pytest.mark.parametrize(
    "cls,kwargs",
    [
        ("BinaryStatScores", {"threshold": 1.5}),
        ("BinaryStatScores", {"multidim_average": "local"}),
        ("BinaryStatScores", {"ignore_index": 0.5}),
        ("MultilabelStatScores", {"num_labels": 1}),
        ("MultilabelStatScores", {"num_labels": 3, "average": "samples"}),
        ("BinaryFBetaScore", {"beta": -1.0}),
    ],
)
def test_validation_parity(cls, kwargs):
    with pytest.raises(ValueError):
        getattr(jc, cls)(**kwargs)
    with pytest.raises(ValueError):
        getattr(tc, cls)(**kwargs, **CPU)


def test_binary_samplewise_without_extra_dims():
    # (N,) inputs: JAX's sum over no axes keeps each element, where torch's `sum(dim=())` would sum all
    (jp, jt), (tp, tt) = _both(*_batch("binary", 62, logits=True))
    want = jss.binary_stat_scores(jp, jt, multidim_average="samplewise")
    got = tss.binary_stat_scores(tp, tt, multidim_average="samplewise")
    assert tuple(got.shape) == (N, 5)
    np.testing.assert_array_equal(_np(got), _np(want))
