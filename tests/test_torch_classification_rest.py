"""Parity of the rest of the port's classification with the JAX package.

Hinge loss, exact match, group fairness, Dice, the fixed operating points
and the utilities they need (``utilities/{enums,checks,formatting}``): the
same seeded numpy inputs go through both packages, the port on the CPU.
Integer states and counts must be equal; float states and values within
1e-5 relative (float32 sums in another order than XLA's).

Edge cases: out-of-range hinge targets (a zero one-hot row, as
``jax.nn.one_hot`` gives), the ``(N, C, S)`` reshape that does not move the
class axis, group ids wrapped once and then dropped, ``ignore_index`` None,
-1 and 255, and Dice's void-label error on Cityscapes-shaped targets.
"""

import importlib
import logging
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu.collections as jcol
import torchmetrics_tpu.utilities.enums as jenums
import torchmetrics_tpu_torch
import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.collections as tcol
import torchmetrics_tpu_torch.utilities as tutil
import torchmetrics_tpu_torch.utilities.enums as tenums
from torchmetrics_tpu.utilities import formatting as jfmt
from torchmetrics_tpu_torch.convert import state_from_jax
from torchmetrics_tpu_torch.utilities import checks as tchecks
from torchmetrics_tpu_torch.utilities import formatting as tfmt

jmod = {m: importlib.import_module(f"torchmetrics_tpu.functional.classification.{m}")
        for m in ("hinge", "exact_match", "group_fairness", "dice", "fixed_operating_point")}
tmod = {m: importlib.import_module(f"torchmetrics_tpu_torch.functional.classification.{m}")
        for m in ("hinge", "exact_match", "group_fairness", "dice", "fixed_operating_point")}

CPU = {"device": "cpu"}
RTOL = 1e-5
N, C, L = 64, 5, 4


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL):
    """Recursive over dicts, tuples and lists; integers equal, floats within rtol, NaNs in place."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], rtol)
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol)
        return
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if np.issubdtype(w.dtype, np.integer):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=rtol, atol=1e-6, equal_nan=True)


def _multiclass(seed, n=N, c=C, logits=False, spatial=(), labels=False):
    rng = np.random.default_rng(seed)
    target = rng.integers(0, c, (n, *spatial)).astype(np.int64)
    if labels:
        return rng.integers(0, c, (n, *spatial)).astype(np.int64), target
    raw = rng.normal(scale=2.0, size=(n, c, *spatial)).astype(np.float32)
    if logits:
        return raw, target
    e = np.exp(raw - raw.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32), target


def _binary(seed, n=N, logits=False, shape=None):
    rng = np.random.default_rng(seed)
    shape = shape or (n,)
    p = rng.uniform(size=shape).astype(np.float32)
    t = (rng.uniform(size=shape) < 0.4).astype(np.int64)
    if logits:
        p = (6 * p - 3).astype(np.float32)
    return p, t


def _state_np(state):
    return {k: ([np.asarray(x) for x in v] if isinstance(v, (tuple, list)) else np.asarray(v)) for k, v in state.items()}


def _drive(jm, tm, batches):
    """Update both with every batch but the last, forward the last; compare states, values, a JAX state carried over."""
    for args in batches[:-1]:
        jm.update(*map(jnp.asarray, args))
        tm.update(*map(torch.from_numpy, args))
    _close(tm.metric_state, {k: v for k, v in jm.metric_state.items()})
    _close(tm.compute(), jm.compute())
    _close(tm(*map(torch.from_numpy, batches[-1])), jm(*map(jnp.asarray, batches[-1])))
    _close(tm.metric_state, jm.metric_state)
    _close(tm.compute_state(state_from_jax(tm, _state_np(jm.metric_state))), jm.compute())


# -------------------------------------------------------------------- hinge
HINGE_MC = {
    "probs": {},
    "logits": {"logits": True},
    "spatial-logits": {"logits": True, "spatial": (3,)},
}


@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("mode", ["crammer-singer", "one-vs-all"])
@pytest.mark.parametrize("case", list(HINGE_MC))
def test_multiclass_hinge(case, mode, squared):
    p, t = _multiclass(1, **HINGE_MC[case])
    t.reshape(-1)[::7] = C + 2  # out of range: a zero one-hot row
    t.reshape(-1)[1::7] = -1
    for ignore_index in (None, -1):
        want = jmod["hinge"].multiclass_hinge_loss(jnp.asarray(p), jnp.asarray(t), C, squared, mode, ignore_index)
        got = tmod["hinge"].multiclass_hinge_loss(torch.from_numpy(p), torch.from_numpy(t), C, squared, mode,
                                                  ignore_index)
        _close(got, want)


@pytest.mark.parametrize("ignore_index", [None, -1, 255])
@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("logits", [False, True], ids=["probs", "logits"])
def test_binary_hinge(logits, squared, ignore_index):
    p, t = _binary(2, logits=logits)
    t[::6] = -1 if ignore_index != 255 else 255
    want = jmod["hinge"].binary_hinge_loss(jnp.asarray(p), jnp.asarray(t), squared, ignore_index)
    _close(tmod["hinge"].binary_hinge_loss(torch.from_numpy(p), torch.from_numpy(t), squared, ignore_index), want)


@pytest.mark.parametrize("kwargs", [{}, {"squared": True, "ignore_index": -1}], ids=["plain", "squared-ignore"])
@pytest.mark.parametrize("name,task", [("BinaryHingeLoss", "binary"), ("MulticlassHingeLoss", "cs"),
                                       ("MulticlassHingeLoss", "ova")])
def test_hinge_classes(name, task, kwargs):
    extra = {} if task == "binary" else {"num_classes": C, "multiclass_mode": "one-vs-all" if task == "ova" else
                                         "crammer-singer"}
    jm, tm = getattr(jc, name)(**extra, **kwargs), getattr(tc, name)(**extra, **kwargs, **CPU)
    batches = []
    for seed in range(3):
        p, t = _binary(10 + seed, logits=seed == 1) if task == "binary" else _multiclass(10 + seed, logits=seed == 1)
        t[::5] = -1
        batches.append((p, t))
    _drive(jm, tm, batches)


def test_hinge_dispatch():
    p, t = _binary(3)
    want = jmod["hinge"].hinge_loss(jnp.asarray(p), jnp.asarray(t), "binary")
    _close(tmod["hinge"].hinge_loss(torch.from_numpy(p), torch.from_numpy(t), "binary"), want)
    assert type(tc.HingeLoss(task="binary", num_classes=3, multiclass_mode="one-vs-all", **CPU)) is tc.BinaryHingeLoss
    assert type(tc.HingeLoss(task="multiclass", num_classes=3, **CPU)) is tc.MulticlassHingeLoss
    with pytest.raises(ValueError):
        tc.HingeLoss(task="multilabel", **CPU)
    with pytest.raises(ValueError, match="multiclass_mode"):
        tmod["hinge"].multiclass_hinge_loss(torch.rand(4, 3), torch.zeros(4, dtype=torch.int64), 3,
                                            multiclass_mode="bogus")


# -------------------------------------------------------------- exact match
@pytest.mark.parametrize("average", ["global", "samplewise"])
@pytest.mark.parametrize("case", ["labels", "probs", "spatial-labels", "spatial-logits"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multiclass_exact_match(case, average, ignore_index):
    spatial = (3,) if case.startswith("spatial") else ()
    p, t = _multiclass(4, n=32, c=3, spatial=spatial, labels="labels" in case, logits="logits" in case)
    if spatial:
        p[::2] = p[::2] if "labels" not in case else t[::2]  # some samples right everywhere
    if ignore_index is not None:
        t.reshape(-1)[::4] = -1
        t[3] = -1  # a sample ignored everywhere
    want = jmod["exact_match"].multiclass_exact_match(jnp.asarray(p), jnp.asarray(t), 3, average, ignore_index)
    got = tmod["exact_match"].multiclass_exact_match(torch.from_numpy(p), torch.from_numpy(t), 3, average, ignore_index)
    _close(got, want)


@pytest.mark.parametrize("average", ["global", "samplewise"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multilabel_exact_match(average, ignore_index):
    p, t = _binary(5, shape=(40, 3))
    t[::3] = (p[::3] > 0.5)  # some samples right on every label
    if ignore_index is not None:
        t[1::4, 0] = -1
    want = jmod["exact_match"].multilabel_exact_match(jnp.asarray(p), jnp.asarray(t), 3, 0.5, average, ignore_index)
    got = tmod["exact_match"].multilabel_exact_match(torch.from_numpy(p), torch.from_numpy(t), 3, 0.5, average,
                                                     ignore_index)
    _close(got, want)


@pytest.mark.parametrize("average", ["global", "samplewise"])
@pytest.mark.parametrize("name", ["MulticlassExactMatch", "MultilabelExactMatch"])
def test_exact_match_classes(name, average):
    kw = {"num_classes": 3} if name.startswith("Multiclass") else {"num_labels": 3}
    jm = getattr(jc, name)(multidim_average=average, ignore_index=-1, **kw)
    tm = getattr(tc, name)(multidim_average=average, ignore_index=-1, **kw, **CPU)
    batches = []
    for seed in range(3):
        if name.startswith("Multiclass"):
            p, t = _multiclass(20 + seed, n=16, c=3, spatial=(2,), labels=True)
            p[::2] = t[::2]
            t[5] = -1
        else:
            p, t = _binary(20 + seed, shape=(16, 3))
            t[::2] = p[::2] > 0.5
            t[1::5, 1] = -1
        batches.append((p, t))
    _drive(jm, tm, batches)
    if average == "samplewise":
        assert isinstance(tm.metric_state["correct"], tuple) and tm.metric_state["correct"][0].dtype == torch.float32


def test_exact_match_dispatch():
    p, t = _multiclass(6, c=3, labels=True)
    want = jmod["exact_match"].exact_match(jnp.asarray(p), jnp.asarray(t), "multiclass", num_classes=3)
    _close(tmod["exact_match"].exact_match(torch.from_numpy(p), torch.from_numpy(t), "multiclass", num_classes=3), want)
    assert type(tc.ExactMatch(task="multilabel", num_labels=3, num_classes=4, **CPU)) is tc.MultilabelExactMatch
    assert type(tc.ExactMatch(task="multiclass", num_classes=3, threshold=0.2, **CPU)) is tc.MulticlassExactMatch
    with pytest.raises(ValueError):
        tc.ExactMatch(task="binary", **CPU)


# ----------------------------------------------------------- group fairness
GROUPS = {
    "in-range": lambda rng, n: rng.integers(0, 3, n),
    "wrap-and-drop": lambda rng, n: rng.choice([-1, 0, 2, 5, -3, -4, 1], n),
}


@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("groups", list(GROUPS))
def test_group_stat_scores(groups, ignore_index):
    rng = np.random.default_rng(7)
    p, t = _binary(7, logits=True)
    g = GROUPS[groups](rng, N).astype(np.int64)
    t[::9] = -1
    want = jmod["group_fairness"]._groups_stat_scores(jnp.asarray(p), jnp.asarray(t), jnp.asarray(g), 3, 0.5,
                                                      ignore_index)
    got = tmod["group_fairness"]._groups_stat_scores(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(g), 3,
                                                     0.5, ignore_index)
    _close(got, want)


def test_group_ids_wrap_once_then_drop():
    """JAX's scatter rule: with 3 groups, -1 counts in group 2 and 5 is dropped."""
    p = torch.tensor([0.9, 0.9, 0.9, 0.9])
    t = torch.tensor([1, 1, 1, 1])
    g = torch.tensor([-1, 0, 2, 5])
    tp, _, _, _ = tmod["group_fairness"]._groups_stat_scores(p, t, g, 3)
    assert tp.tolist() == [1.0, 0.0, 2.0]


@pytest.mark.parametrize("task", ["demographic_parity", "equal_opportunity", "all"])
def test_binary_fairness(task):
    rng = np.random.default_rng(8)
    p, t = _binary(8)
    g = rng.integers(0, 3, N).astype(np.int64)
    want = jmod["group_fairness"].binary_fairness(jnp.asarray(p), jnp.asarray(t), jnp.asarray(g), task)
    got = tmod["group_fairness"].binary_fairness(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(g), task)
    _close(got, want)
    want = jmod["group_fairness"].binary_groups_stat_rates(jnp.asarray(p), jnp.asarray(t), jnp.asarray(g), 3)
    _close(tmod["group_fairness"].binary_groups_stat_rates(torch.from_numpy(p), torch.from_numpy(t),
                                                           torch.from_numpy(g), 3), want)
    with pytest.raises(ValueError, match="task"):
        tmod["group_fairness"].binary_fairness(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(g), "bogus")


@pytest.mark.parametrize("name,kwargs", [("BinaryGroupStatRates", {}), ("BinaryFairness", {"task": "all"}),
                                         ("BinaryFairness", {"task": "demographic_parity", "ignore_index": -1})])
def test_fairness_classes(name, kwargs):
    jm, tm = getattr(jc, name)(num_groups=3, **kwargs), getattr(tc, name)(num_groups=3, **kwargs, **CPU)
    rng = np.random.default_rng(9)
    batches = []
    for seed in range(3):
        p, t = _binary(30 + seed, logits=seed == 0)
        t[::7] = -1 if "ignore_index" in kwargs else t[::7]
        batches.append((p, t, rng.choice([-1, 0, 1, 2, 4], N).astype(np.int64)))
    _drive(jm, tm, batches)
    assert all(tm.metric_state[k].dtype == torch.float32 for k in ("tp", "fp", "tn", "fn"))
    with pytest.raises(ValueError, match="num_groups"):
        getattr(tc, name)(num_groups=1, **CPU)


# --------------------------------------------------------------------- dice
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("case", ["labels", "probs", "spatial-logits"])
@pytest.mark.parametrize("ignore_index", [None, 2])
def test_functional_dice(case, average, ignore_index):
    spatial = (3,) if case.startswith("spatial") else ()
    p, t = _multiclass(11, spatial=spatial, labels=case == "labels", logits="logits" in case)
    want = jmod["dice"].dice(jnp.asarray(p), jnp.asarray(t), C, average, ignore_index)
    _close(tmod["dice"].dice(torch.from_numpy(p), torch.from_numpy(t), C, average, ignore_index), want)


DICE_INPUTS = {
    "probs": lambda s: _multiclass(s),
    "labels": lambda s: _multiclass(s, labels=True),
    "spatial-probs": lambda s: _multiclass(s, spatial=(2, 3)),
    "spatial-labels": lambda s: _multiclass(s, spatial=(3,), labels=True),
}


DICE_KWARGS = {"micro": {"average": "micro"}, "macro-ignore": {"average": "macro", "ignore_index": 1},
               "weighted": {"average": "weighted"}, "none-top2": {"average": "none", "top_k": 2}}
# top_k needs probabilities: its refusal on labels is in test_dice_errors
DICE_CLASS_CASES = [(c, k) for c in DICE_INPUTS for k in DICE_KWARGS if not (k == "none-top2" and "labels" in c)]


@pytest.mark.parametrize("case,kw_id", DICE_CLASS_CASES, ids=[f"{c}-{k}" for c, k in DICE_CLASS_CASES])
def test_dice_class(case, kw_id):
    kwargs = DICE_KWARGS[kw_id]
    jm, tm = jc.Dice(num_classes=C, **kwargs), tc.Dice(num_classes=C, **kwargs, **CPU)
    _drive(jm, tm, [DICE_INPUTS[case](40 + s) for s in range(3)])
    assert tm.metric_state["tp"].dtype == torch.int32


def test_dice_binary_and_multilabel_inputs():
    p, t = _binary(12)
    jm, tm = jc.Dice(num_classes=2, multiclass=True), tc.Dice(num_classes=2, multiclass=True, **CPU)
    _drive(jm, tm, [_binary(12 + s) for s in range(3)])
    ml = [_binary(20 + s, shape=(N, 3)) for s in range(3)]
    jm, tm = jc.Dice(num_classes=3, average="macro"), tc.Dice(num_classes=3, average="macro", **CPU)
    _drive(jm, tm, ml)


def _error(fn):
    try:
        fn()
    except ValueError as err:
        return str(err)
    return None


@pytest.mark.parametrize("ignore_index", [None, 255])
def test_dice_void_label_error(ignore_index):
    """Cityscapes-shaped scores (N, 19, H, W) with void 255 targets: the JAX error, also with ignore_index=255."""
    rng = np.random.default_rng(13)
    logits = rng.normal(size=(2, 19, 8, 16)).astype(np.float32)
    target = rng.integers(0, 19, (2, 8, 16)).astype(np.int64)
    target[:, ::3, ::5] = 255
    want = _error(lambda: jc.Dice(num_classes=19, ignore_index=ignore_index).update(jnp.asarray(logits),
                                                                                   jnp.asarray(target)))
    got = _error(lambda: tc.Dice(num_classes=19, ignore_index=ignore_index, **CPU).update(
        torch.from_numpy(logits), torch.from_numpy(target)))
    assert want == got == "The highest `target` label must be below the C dimension of `preds`."


DICE_ERRORS = [
    ("float target", lambda m: (np.zeros(4, np.float32), np.zeros(4, np.float32)), {}),
    ("batch mismatch", lambda m: (np.zeros(4, np.float32), np.zeros(3, np.int64)), {}),
    ("binary without multiclass", lambda m: _binary(1), {"num_classes": 2}),
    ("labels beyond num_classes", lambda m: (np.full(4, 7), np.zeros(4, np.int64)), {}),
    ("top_k on labels", lambda m: _multiclass(1, labels=True), {"top_k": 2}),
    ("negative target", lambda m: (np.zeros((4, C), np.float32), np.full(4, -2)), {}),
]


@pytest.mark.parametrize("what,make,kwargs", DICE_ERRORS, ids=[e[0] for e in DICE_ERRORS])
def test_dice_errors(what, make, kwargs):
    p, t = make(None)
    kw = {"num_classes": C, **kwargs}
    want = _error(lambda: jc.Dice(**kw).update(jnp.asarray(p), jnp.asarray(t)))
    got = _error(lambda: tc.Dice(**kw, **CPU).update(torch.from_numpy(np.asarray(p)), torch.from_numpy(np.asarray(t))))
    assert want is not None and got == want


# --------------------------------------------------------- fixed operating points
FIXED = [
    ("PrecisionAtFixedRecall", "min_recall", "precision_at_fixed_recall"),
    ("RecallAtFixedPrecision", "min_precision", "recall_at_fixed_precision"),
    ("SensitivityAtSpecificity", "min_specificity", "sensitivity_at_specificity"),
    ("SpecificityAtSensitivity", "min_sensitivity", "specificity_at_sensitivity"),
]


def _task_batch(task, seed):
    if task == "binary":
        return _binary(seed)
    if task == "multiclass":
        return _multiclass(seed)
    return _binary(seed, shape=(N, L))


@pytest.mark.parametrize("thresholds", [None, 11], ids=["exact", "binned"])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("name,min_arg,fn", FIXED, ids=[f[0] for f in FIXED])
def test_fixed_point_classes(name, min_arg, fn, task, thresholds):
    cls = {"binary": "Binary", "multiclass": "Multiclass", "multilabel": "Multilabel"}[task] + name
    kw = {"num_classes": C} if task == "multiclass" else {"num_labels": L} if task == "multilabel" else {}
    jm = getattr(jc, cls)(min_value=0.4, thresholds=thresholds, **kw)
    tm = getattr(tc, cls)(min_value=0.4, thresholds=thresholds, **kw, **CPU)
    batches = [_task_batch(task, 50 + s) for s in range(2)]
    _drive(jm, tm, batches)
    # the constraint under its own name goes through the task wrapper; the task class takes
    # `min_value` only, in both packages
    for make, extra in ((getattr(jc, cls), {}), (getattr(tc, cls), CPU)):
        with pytest.raises(TypeError, match="min_value"):
            make(**{min_arg: 0.4}, thresholds=thresholds, **kw, **extra)
    wrapped = getattr(tc, name)(task=task, **{min_arg: 0.4}, thresholds=thresholds, **kw, **CPU)
    assert type(wrapped).__name__ == cls
    for p, t in batches:
        wrapped.update(torch.from_numpy(p), torch.from_numpy(t))
    _close(wrapped.compute(), jm.compute())


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("name,min_arg,fn", FIXED, ids=[f[0] for f in FIXED])
def test_fixed_point_functional(name, min_arg, fn, task):
    p, t = _task_batch(task, 70)
    kw = {"num_classes": C} if task == "multiclass" else {"num_labels": L} if task == "multilabel" else {}
    for thresholds in (None, 9):
        want = getattr(jmod["fixed_operating_point"], fn)(jnp.asarray(p), jnp.asarray(t), task, 0.6, thresholds, **kw)
        got = getattr(tmod["fixed_operating_point"], fn)(torch.from_numpy(p), torch.from_numpy(t), task, 0.6,
                                                         thresholds, **kw)
        _close(got, want)
    with pytest.raises(ValueError, match=min_arg):
        getattr(tmod["fixed_operating_point"], fn)(torch.from_numpy(p), torch.from_numpy(t), task, 1.5, **kw)


def test_best_at_constraint_fallbacks():
    fop = tmod["fixed_operating_point"]
    obj, con, thr = torch.tensor([0.0, 0.0, 0.5]), torch.tensor([0.9, 0.8, 0.1]), torch.tensor([0.2, 0.4, 0.6])
    assert [float(x) for x in fop._best_at_constraint(obj, con, thr, 0.5)] == [0.0, 1e6]  # PR: sentinel at 0
    assert [float(x) for x in fop._best_at_constraint(obj, con, thr, 0.5, zero_sentinel=False)] == \
        [0.0, pytest.approx(0.2)]
    assert [float(x) for x in fop._best_at_constraint(obj, con, thr, 0.95)] == [0.0, 1e6]  # none meets it
    assert fop._lexargmax(np.array([[1.0, 0.5, 0.2], [1.0, 0.7, 0.1], [0.9, 0.9, 0.9]])) == 1


def test_fixed_point_collection_shares_the_curve_state():
    kw = {"num_labels": L, "thresholds": 11}
    jcoll = jcol.MetricCollection({"r": jc.MultilabelRecallAtFixedPrecision(min_value=0.5, **kw),
                                   "p": jc.MultilabelPrecisionAtFixedRecall(min_value=0.5, **kw)})
    tcoll = tcol.MetricCollection({"r": tc.MultilabelRecallAtFixedPrecision(min_value=0.5, **kw, **CPU),
                                   "p": tc.MultilabelPrecisionAtFixedRecall(min_value=0.5, **kw, **CPU)})
    for seed in range(3):
        p, t = _binary(80 + seed, shape=(N, L))
        jcoll.update(jnp.asarray(p), jnp.asarray(t))
        tcoll.update(torch.from_numpy(p), torch.from_numpy(t))
    assert [sorted(g) for g in tcoll.compute_groups.values()] == [["p", "r"]]
    _close(tcoll.compute(), jcoll.compute())
    clone = pickle.loads(pickle.dumps(tcoll["r"]))
    _close(clone.compute(), tcoll["r"].compute())


# ---------------------------------------------------------------- utilities
def test_enums():
    for name in ("DataType", "AverageMethod", "MDMCAverageMethod", "ClassificationTask",
                 "ClassificationTaskNoBinary", "ClassificationTaskNoMultilabel"):
        t_enum, j_enum = getattr(tenums, name), getattr(jenums, name)
        assert [(m.name, m.value) for m in t_enum] == [(m.name, m.value) for m in j_enum]
        for m in t_enum:
            assert t_enum.from_str(m.value) is m and str(m) == str(getattr(j_enum, m.name))
    assert tenums.ClassificationTask.from_str("Multi-Class".replace("-", "")) is tenums.ClassificationTask.MULTICLASS
    with pytest.raises(ValueError, match="Invalid"):
        tenums.ClassificationTask.from_str("regression")
    with pytest.raises(ValueError, match="Invalid DataType"):
        tenums.DataType.from_str("bogus")
    tenums._check_average_arg("macro")
    with pytest.raises(ValueError, match="average"):
        tenums._check_average_arg("mean")


FORMAT_CASES = {
    "binary-probs": (lambda: _binary(1), {}),
    "binary-promoted": (lambda: _binary(1), {"num_classes": 2, "multiclass": True}),
    "multiclass-probs": (lambda: _multiclass(1), {}),
    "multiclass-top2": (lambda: _multiclass(1), {"top_k": 2}),
    "multiclass-labels": (lambda: _multiclass(1, labels=True), {"num_classes": C}),
    "multiclass-labels-inferred": (lambda: _multiclass(1, labels=True), {}),
    "multiclass-demoted": (lambda: _multiclass(1, c=2), {"multiclass": False}),
    "multilabel": (lambda: _binary(1, shape=(N, L)), {}),
    "multilabel-top1": (lambda: _binary(1, shape=(N, L)), {"top_k": 1}),
    "multilabel-promoted": (lambda: _binary(1, shape=(N, L)), {"multiclass": True, "num_classes": 2}),
    "mdmc-probs": (lambda: _multiclass(1, spatial=(3, 2)), {}),
    "mdmc-labels": (lambda: _multiclass(1, spatial=(3,), labels=True), {"num_classes": C}),
    "leading-one": (lambda: tuple(x[:1] for x in _multiclass(1)), {}),
    "empty": (lambda: (np.zeros((0,), np.float32), np.zeros((0,), np.int64)), {}),
    "float16": (lambda: (_multiclass(1)[0].astype(np.float16), _multiclass(1)[1]), {}),
    # errors, with the JAX messages
    "err-target-float": (lambda: (np.zeros(4, np.float32), np.zeros(4, np.float32)), {}),
    "err-batch": (lambda: (np.zeros(4, np.float32), np.zeros(5, np.int64)), {}),
    "err-shapes": (lambda: (np.zeros((4, 2), np.float32), np.zeros((4, 3), np.int64)), {}),
    "err-binary-target": (lambda: (np.zeros(4, np.float32), np.array([0, 1, 2, 0])), {}),
    "err-int-extra-dim": (lambda: (np.zeros((4, 3), np.int64), np.zeros(4, np.int64)), {}),
    "err-trailing": (lambda: (np.zeros((4, 3, 2), np.float32), np.zeros((4, 3), np.int64)), {}),
    "err-rank": (lambda: (np.zeros((4, 3, 2, 2), np.float32), np.zeros(4, np.int64)), {}),
    "err-negative-target": (lambda: _multiclass(1), {"ignore_index": None, "num_classes": C}),
    "err-negative-preds": (lambda: (np.full(4, -1), np.zeros(4, np.int64)), {}),
    "err-target-above-c": (lambda: (np.zeros((4, 3), np.float32), np.array([0, 1, 3, 0])), {}),
    "err-binary-3": (lambda: _binary(1), {"num_classes": 3}),
    "err-binary-mc1": (lambda: _binary(1), {"num_classes": 1, "multiclass": True}),
    "err-nc1": (lambda: _multiclass(1), {"num_classes": 1}),
    "err-demote-3": (lambda: _multiclass(1, c=3), {"multiclass": False}),
    "err-nc-mismatch": (lambda: _multiclass(1), {"num_classes": C + 1}),
    "err-preds-label": (lambda: (np.array([0, 6, 1]), np.array([0, 1, 1])), {"num_classes": 5}),
    "err-ml-promote": (lambda: _binary(1, shape=(N, L)), {"multiclass": True, "num_classes": 3}),
    "err-ml-count": (lambda: _binary(1, shape=(N, L)), {"num_classes": L + 1}),
    "err-topk-binary": (lambda: _binary(1), {"top_k": 1}),
    "err-topk-labels": (lambda: _multiclass(1, labels=True), {"top_k": 1}),
    "err-topk-demote": (lambda: _multiclass(1, c=2), {"top_k": 1, "multiclass": False}),
    "err-topk-big": (lambda: _multiclass(1), {"top_k": C}),
    "err-topk-zero": (lambda: _multiclass(1), {"top_k": 0}),
    "err-demote-target": (lambda: _multiclass(1, c=2), {"multiclass": False, "num_classes": 2}),
}


def _negative(case, p, t):
    if case == "err-negative-target":
        t = t.copy()
        t[0] = -3
    return p, t


@pytest.mark.parametrize("case", list(FORMAT_CASES))
def test_classify_inputs_parity(case):
    make, kwargs = FORMAT_CASES[case]
    p, t = _negative(case, *make())
    if case == "err-demote-target":
        t = t + 1
    want = got = None
    try:
        want = jfmt.classify_inputs(jnp.asarray(p), jnp.asarray(t), **kwargs)
    except ValueError as err:
        want = str(err)
    try:
        got = tfmt.classify_inputs(torch.from_numpy(np.asarray(p)), torch.from_numpy(np.asarray(t)), **kwargs)
    except ValueError as err:
        got = str(err)
    if isinstance(want, str):
        assert got == want
        return
    assert not isinstance(got, str), got
    assert got[2] is tenums.DataType(want[2].value)
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    alias = tchecks._input_format_classification(torch.from_numpy(np.asarray(p)), torch.from_numpy(np.asarray(t)),
                                                 **kwargs)
    assert torch.equal(alias[0], got[0]) and alias[2] is got[2]


def test_formatting_reads_the_device_once(monkeypatch):
    """The value checks read one stack of extremes from the device, not the tensors."""
    reads = []
    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist", lambda self: reads.append(self.shape) or real(self))
    p, t = _multiclass(1, labels=True)
    tfmt.classify_inputs(torch.from_numpy(p), torch.from_numpy(t))
    assert reads == [torch.Size([4])]


def test_check_forward_full_state_property(caplog):
    p, t = _multiclass(2)
    with caplog.at_level(logging.INFO, logger="torchmetrics_tpu_torch"):
        tchecks.check_forward_full_state_property(
            tc.MulticlassExactMatch, init_args={"num_classes": C, **CPU},
            input_args={"preds": torch.from_numpy(p), "target": torch.from_numpy(t)}, num_update_to_compare=3, reps=1)
    assert "Recommended setting `full_state_update=" in caplog.text

    class Broken(tc.BinaryHingeLoss):
        def _update(self, state, preds, target):  # drops the old state: does not distribute over merge
            return super()._update(self.init_state(), preds, target)

        def _compute(self, state):
            return state["total"]  # the samples counted: one batch's under full_state_update, all of them else

    with pytest.raises(RuntimeError, match="cannot safely set"):
        tchecks.check_forward_full_state_property(
            Broken, init_args=CPU, input_args={"preds": torch.rand(8), "target": torch.ones(8, dtype=torch.int64)},
            num_update_to_compare=2)


def test_exports():
    for name in ("CalibrationError", "Dice", "ExactMatch", "HingeLoss", "BinaryFairness",
                 "MultilabelRankingLoss", "SpecificityAtSensitivity", "MulticlassRecallAtFixedPrecision"):
        assert getattr(torchmetrics_tpu_torch, name) is getattr(tc, name)
        assert name in tc.__all__ and name in torchmetrics_tpu_torch.__all__
    fc = importlib.import_module("torchmetrics_tpu_torch.functional.classification")
    jfc = importlib.import_module("torchmetrics_tpu.functional.classification")
    for name in ("binary_calibration_error", "dice", "exact_match", "hinge_loss", "binary_fairness",
                 "binary_groups_stat_rates", "multilabel_ranking_loss", "specificity_at_sensitivity"):
        assert callable(getattr(fc, name)) and hasattr(jfc, name)
    assert tutil.classify_inputs is tfmt.classify_inputs


def _rest_collection(pkg, col, **device):
    kw = {"num_classes": C, **device}
    return col.MetricCollection({
        "hinge": pkg.MulticlassHingeLoss(**kw), "hinge_ova": pkg.MulticlassHingeLoss(multiclass_mode="one-vs-all", **kw),
        "exact": pkg.MulticlassExactMatch(**kw), "dice": pkg.Dice(average="macro", **kw),
    })


def test_rest_in_a_collection():
    jcoll, tcoll = _rest_collection(jc, jcol), _rest_collection(tc, tcol, **CPU)
    for seed in range(3):
        p, t = _multiclass(90 + seed, logits=seed == 1)
        jcoll.update(jnp.asarray(p), jnp.asarray(t))
        tcoll.update(torch.from_numpy(p), torch.from_numpy(t))
    _close(tcoll.compute(), jcoll.compute())
    fair_j = jcol.MetricCollection({"f": jc.BinaryFairness(num_groups=2), "r": jc.BinaryGroupStatRates(num_groups=2)})
    fair_t = tcol.MetricCollection({"f": tc.BinaryFairness(num_groups=2, **CPU),
                                    "r": tc.BinaryGroupStatRates(num_groups=2, **CPU)})
    rng = np.random.default_rng(95)
    for seed in range(2):
        p, t = _binary(96 + seed)
        g = rng.integers(0, 2, N).astype(np.int64)
        fair_j.update(jnp.asarray(p), jnp.asarray(t), jnp.asarray(g))
        fair_t.update(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(g))
    assert [sorted(m) for m in fair_t.compute_groups.values()] == [["f", "r"]]
    _close(fair_t.compute(), fair_j.compute())
