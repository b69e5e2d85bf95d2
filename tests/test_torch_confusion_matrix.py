"""Parity of the port's confusion-matrix family with the JAX package.

Inputs are made from a seed with numpy and fed to both packages; the port
runs on the CPU, where the multiclass update is the plain version of the
``confmat_multiclass`` CUDA kernel (``chip_smoke.py`` holds the kernel against
it on the card). Confusion matrices are counts and must be exactly equal, and
int32. Normalized matrices, kappa, MCC and Jaccard are float32 reductions
taken in another order than XLA's: within ``ATOL = 1e-6``.
"""

import collections
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
from torchmetrics_tpu_torch.kernels import confmat as kcm

# both functional namespaces re-export functions named like these modules
jcm = importlib.import_module("torchmetrics_tpu.functional.classification.confusion_matrix")
tcm = importlib.import_module("torchmetrics_tpu_torch.functional.classification.confusion_matrix")
jfk = importlib.import_module("torchmetrics_tpu.functional.classification.cohen_kappa")
tfk = importlib.import_module("torchmetrics_tpu_torch.functional.classification.cohen_kappa")
jfm = importlib.import_module("torchmetrics_tpu.functional.classification.matthews_corrcoef")
tfm = importlib.import_module("torchmetrics_tpu_torch.functional.classification.matthews_corrcoef")
jfj = importlib.import_module("torchmetrics_tpu.functional.classification.jaccard")
tfj = importlib.import_module("torchmetrics_tpu_torch.functional.classification.jaccard")

ATOL = 1e-6
C, L, N = 6, 5, 96
NORMALIZE = [None, "true", "pred", "all"]
CPU = {"device": "cpu"}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_equal_counts(got, want):
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), _np(want))


def _assert_close(got, want):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL)


def _multiclass(seed, n=N, num_classes=C, spatial=(), logits=False, ignore_index=None, labels=False):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(n, num_classes, *spatial)).astype(np.float32)
    if not logits:
        scores = np.exp(scores) / np.exp(scores).sum(1, keepdims=True)
    target = rng.integers(0, num_classes, size=(n, *spatial)).astype(np.int32)
    if ignore_index is not None:
        target[rng.random(target.shape) < 0.2] = ignore_index
    preds = scores.argmax(1).astype(np.int32) if labels else scores.astype(np.float32)
    return preds, target


def _binary(seed, n=N, logits=False, ignore_index=None, shape=None):
    rng = np.random.default_rng(seed)
    shape = shape or (n,)
    scores = rng.normal(size=shape).astype(np.float32)
    preds = scores if logits else (1 / (1 + np.exp(-scores))).astype(np.float32)
    target = rng.integers(0, 2, size=shape).astype(np.int32)
    if ignore_index is not None:
        target[rng.random(shape) < 0.2] = ignore_index
    return preds, target


# ---------------------------------------------------------------- functional
@pytest.mark.parametrize("normalize", NORMALIZE)
@pytest.mark.parametrize("case", ["probs", "logits", "labels", "spatial", "ignore", "ignore_neg"])
def test_multiclass_confusion_matrix_parity(case, normalize):
    kwargs = {
        "probs": {}, "logits": {"logits": True}, "labels": {"labels": True}, "spatial": {"n": 4, "spatial": (8, 8)},
        "ignore": {"ignore_index": 2}, "ignore_neg": {"ignore_index": -1},
    }[case]
    num_classes = 5 if case == "spatial" else C
    preds, target = _multiclass(7, num_classes=num_classes, **kwargs)
    ignore_index = kwargs.get("ignore_index")
    (jp, jt), (tp, tt) = _both(preds, target)
    want = jcm.multiclass_confusion_matrix(jp, jt, num_classes, normalize, ignore_index)
    got = tcm.multiclass_confusion_matrix(tp, tt, num_classes, normalize, ignore_index)
    (_assert_equal_counts if normalize is None else _assert_close)(got, want)


@pytest.mark.parametrize("normalize", NORMALIZE)
@pytest.mark.parametrize("case", ["probs", "logits", "ignore", "samples"])
def test_binary_confusion_matrix_parity(case, normalize):
    preds, target = _binary(3, logits=case == "logits", ignore_index=-1 if case == "ignore" else None,
                            shape=(8, 12) if case == "samples" else None)
    (jp, jt), (tp, tt) = _both(preds, target)
    ignore_index = -1 if case == "ignore" else None
    want = jcm.binary_confusion_matrix(jp, jt, 0.5, normalize, ignore_index)
    got = tcm.binary_confusion_matrix(tp, tt, 0.5, normalize, ignore_index)
    (_assert_equal_counts if normalize is None else _assert_close)(got, want)


@pytest.mark.parametrize("normalize", NORMALIZE)
@pytest.mark.parametrize("case", ["probs", "logits", "ignore", "spatial"])
def test_multilabel_confusion_matrix_parity(case, normalize):
    shape = (4, L, 8) if case == "spatial" else (N, L)
    preds, target = _binary(5, logits=case == "logits", ignore_index=-1 if case == "ignore" else None, shape=shape)
    (jp, jt), (tp, tt) = _both(preds, target)
    ignore_index = -1 if case == "ignore" else None
    want = jcm.multilabel_confusion_matrix(jp, jt, L, 0.5, normalize, ignore_index)
    got = tcm.multilabel_confusion_matrix(tp, tt, L, 0.5, normalize, ignore_index)
    (_assert_equal_counts if normalize is None else _assert_close)(got, want)


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_confusion_matrix_dispatch(task):
    preds, target = _binary(1, shape=(N, L)) if task == "multilabel" else (
        _binary(1) if task == "binary" else _multiclass(1))
    (jp, jt), (tp, tt) = _both(preds, target)
    kw = {"num_classes": C, "num_labels": L}
    _assert_equal_counts(tcm.confusion_matrix(tp, tt, task, **kw), jcm.confusion_matrix(jp, jt, task, **kw))


# targets and integer predictions outside [0, C): a flat index in [-C*C, 0)
# wraps to another row, anything else out of range is dropped, as in JAX
WRAP_TARGETS = {"C": C, "C+3": C + 3, "-3": -3, "-(C*C+1)": -(C * C + 1), "-1": -1}


@pytest.mark.parametrize("ignore_index", [None, -3, 255])
@pytest.mark.parametrize("value", list(WRAP_TARGETS.values()), ids=list(WRAP_TARGETS))
@pytest.mark.parametrize("labels", [False, True], ids=["scores", "labels"])
def test_wrap_and_drop_of_out_of_range_targets(labels, value, ignore_index):
    preds, target = _multiclass(11, labels=labels)
    target[::4] = value
    (jp, jt), (tp, tt) = _both(preds, target)
    want = jcm.multiclass_confusion_matrix(jp, jt, C, None, ignore_index, validate_args=False)
    got = tcm.multiclass_confusion_matrix(tp, tt, C, None, ignore_index, validate_args=False)
    _assert_equal_counts(got, want)


@pytest.mark.parametrize("value", [C, C + 3, -1, -3, -(C * C + 1), 2**30])
def test_wrap_and_drop_of_out_of_range_label_preds(value):
    preds, target = _multiclass(12, labels=True)
    preds[1::3] = value
    (jp, jt), (tp, tt) = _both(preds, target)
    _assert_equal_counts(tcm.multiclass_confusion_matrix(tp, tt, C, validate_args=False),
                         jcm.multiclass_confusion_matrix(jp, jt, C, validate_args=False))


@pytest.mark.parametrize("value", [2, 5, -1, -3, -5])
@pytest.mark.parametrize("where", ["target", "preds"])
def test_binary_wrap_and_drop(where, value):
    preds, target = _binary(13)
    preds = (preds > 0.5).astype(np.int32)
    (preds if where == "preds" else target)[::3] = value
    (jp, jt), (tp, tt) = _both(preds, target)
    _assert_equal_counts(tcm.binary_confusion_matrix(tp, tt, validate_args=False),
                         jcm.binary_confusion_matrix(jp, jt, validate_args=False))


def test_wrap_rule_example():
    # C=3: target -3 and pred 2 count at flat index -3*3 + 2 = -7, wrapped to 2 = (0, 2)
    state = torch.zeros((3, 3), dtype=torch.int32)
    kcm._confmat_multiclass_plain(state, torch.tensor([2]), torch.tensor([-3]), None)
    assert state.tolist() == [[0, 0, 1], [0, 0, 0], [0, 0, 0]]
    # target -1 and pred 2: -3 + 2 = -1, wrapped to 8 = (2, 2); target -4: -10 is dropped
    kcm._confmat_multiclass_plain(state, torch.tensor([2, 2]), torch.tensor([-1, -4]), None)
    assert state.tolist() == [[0, 0, 1], [0, 0, 0], [0, 0, 1]]


def _edge_scores(dtype):
    """Rows of NaN, ties, signed zeros and -inf, where the argmax rule decides."""
    rng = np.random.default_rng(21)
    scores = rng.normal(size=(24, C)).astype(np.float32)
    nan, inf = np.nan, np.inf
    scores[0] = nan  # all NaN: the first wins
    scores[1, [2, 4]] = nan  # the first NaN beats every number
    scores[2] = 0.5  # all tie: the lowest index
    scores[3, [1, 3]] = 9.0
    scores[4] = [-0.0, 0.0, -0.0, 0.0, -1.0, -2.0]  # -0.0 and +0.0 tie
    scores[5] = [0.0, -0.0, -1, -1, -1, -1]
    scores[6] = -inf  # all -inf: index 0
    scores[7, 5] = inf
    scores[8, [0, 5]] = inf
    scores[9] = [-inf, -inf, nan, -inf, -inf, -inf]
    if dtype == "float16":
        scores[10, [1, 2]] = [1.0001, 1.0002]  # equal in float16: the lower index
    return scores


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_argmax_rules(dtype):
    scores = _edge_scores(dtype)
    target = np.random.default_rng(22).integers(0, C, size=24).astype(np.int32)
    tp = torch.from_numpy(scores).to(getattr(torch, dtype))
    # the JAX side gets the same values, widened to float32 where numpy has no bfloat16
    jp = jnp.asarray(tp.float().numpy()).astype(jnp.float16) if dtype == "float16" else jnp.asarray(tp.float().numpy())
    np.testing.assert_array_equal(kcm._argmax_first(tp).numpy(), np.asarray(jnp.argmax(jp, axis=1)))
    _assert_equal_counts(tcm.multiclass_confusion_matrix(tp, torch.from_numpy(target), C),
                         jcm.multiclass_confusion_matrix(jp, jnp.asarray(target), C))


def test_int64_targets_and_float64_scores():
    preds, target = _multiclass(23, ignore_index=255)
    (jp, jt), _ = _both(preds, target)
    want = jcm.multiclass_confusion_matrix(jp, jt, C, ignore_index=255)
    got = tcm.multiclass_confusion_matrix(torch.from_numpy(preds.astype(np.float64)),
                                          torch.from_numpy(target.astype(np.int64)), C, ignore_index=255)
    _assert_equal_counts(got, want)


def test_empty_batch_adds_nothing():
    state = torch.arange(C * C, dtype=torch.int32).view(C, C)
    before = state.clone()
    kcm._confmat_multiclass_plain(state, torch.zeros((0, C)), torch.zeros((0,), dtype=torch.int64), None)
    assert torch.equal(state, before)


@pytest.mark.parametrize(
    "kwargs",
    [{"normalize": "rows"}, {"ignore_index": 1.5}, {"threshold": 2.0}, {"num_classes": 1}, {"num_labels": 1}],
)
def test_validation_parity(kwargs):
    args = {"normalize": kwargs.get("normalize"), "ignore_index": kwargs.get("ignore_index")}
    rest = {k: v for k, v in kwargs.items() if k not in args}
    with pytest.raises(ValueError):
        jcm._confusion_matrix_validate_args(**args, **rest)
    with pytest.raises(ValueError):
        tcm._confusion_matrix_validate_args(**args, **rest)


# -------------------------------------------------------------- reductions
@pytest.mark.parametrize("weights", [None, "linear", "quadratic"])
@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_cohen_kappa_parity(task, weights):
    preds, target = _binary(31) if task == "binary" else _multiclass(31)
    (jp, jt), (tp, tt) = _both(preds, target)
    _assert_close(tfk.cohen_kappa(tp, tt, task, num_classes=C, weights=weights),
                  jfk.cohen_kappa(jp, jt, task, num_classes=C, weights=weights))


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("degenerate", [False, True])
def test_matthews_corrcoef_parity(task, degenerate):
    preds, target = {"binary": lambda: _binary(32), "multiclass": lambda: _multiclass(32),
                     "multilabel": lambda: _binary(32, shape=(N, L))}[task]()
    if degenerate:  # one class in the target: the 0 of sklearn's convention
        target[:] = 1
    (jp, jt), (tp, tt) = _both(preds, target)
    kw = {"num_classes": C, "num_labels": L}
    _assert_close(tfm.matthews_corrcoef(tp, tt, task, **kw), jfm.matthews_corrcoef(jp, jt, task, **kw))


@pytest.mark.parametrize("zero_division", [0.0, 1.0])
@pytest.mark.parametrize("ignore_index", [None, 2, -1])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
def test_multiclass_jaccard_parity(average, ignore_index, zero_division):
    preds, target = _multiclass(33, ignore_index=ignore_index, num_classes=C)
    preds[:, 4] = 0.0  # a class absent from preds
    target[target == 4] = 0  # and from the target: its union is empty
    (jp, jt), (tp, tt) = _both(preds, target)
    args = (C, average, ignore_index, True, zero_division)
    _assert_close(tfj.multiclass_jaccard_index(tp, tt, *args), jfj.multiclass_jaccard_index(jp, jt, *args))


@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("task", ["binary", "multilabel"])
def test_binary_and_multilabel_jaccard_parity(task, average):
    preds, target = _binary(34, shape=(N, L) if task == "multilabel" else None)
    (jp, jt), (tp, tt) = _both(preds, target)
    kw = {"num_labels": L, "average": average}
    _assert_close(tfj.jaccard_index(tp, tt, task, **kw), jfj.jaccard_index(jp, jt, task, **kw))


@pytest.mark.parametrize("ignore_index", [255, -3, 18, -19, -20])
def test_jaccard_ignore_index_placement(ignore_index):
    # JAX's `.at[i].set` drops an index outside [-C, C) and wraps a negative one:
    # 255 at 19 classes (Cityscapes) masks nothing, -3 masks class 16
    rng = np.random.default_rng(35)
    confmat = rng.integers(0, 50, size=(19, 19)).astype(np.int32)
    for average in ("micro", "macro", "weighted"):
        want = jfj._jaccard_reduce(jnp.asarray(confmat), average, ignore_index)
        got = tfj._jaccard_reduce(torch.from_numpy(confmat), average, ignore_index)
        _assert_close(got, want)
    unmasked = tfj._jaccard_reduce(torch.from_numpy(confmat), "macro", None)
    masked = tfj._jaccard_reduce(torch.from_numpy(confmat), "macro", ignore_index)
    assert torch.equal(masked, unmasked) == (ignore_index in (255, -20))


# ----------------------------------------------------------------- classes
def _state_np(state):
    return {k: ([np.asarray(x) for x in v] if isinstance(v, tuple) else np.asarray(v)) for k, v in state.items()}


def _classes(name, **kwargs):
    return getattr(jc, name)(**kwargs), getattr(tc, name)(**kwargs, **CPU)


MODULAR = [
    ("BinaryConfusionMatrix", {}, "binary"),
    ("BinaryConfusionMatrix", {"normalize": "true", "ignore_index": -1}, "binary"),
    ("MulticlassConfusionMatrix", {"num_classes": C}, "multiclass"),
    ("MulticlassConfusionMatrix", {"num_classes": C, "normalize": "all", "ignore_index": 3}, "multiclass"),
    ("MultilabelConfusionMatrix", {"num_labels": L, "normalize": "pred"}, "multilabel"),
    ("BinaryCohenKappa", {"weights": "linear"}, "binary"),
    ("MulticlassCohenKappa", {"num_classes": C, "weights": "quadratic"}, "multiclass"),
    ("MulticlassCohenKappa", {"num_classes": C}, "multiclass"),
    ("BinaryMatthewsCorrCoef", {}, "binary"),
    ("MulticlassMatthewsCorrCoef", {"num_classes": C}, "multiclass"),
    ("MultilabelMatthewsCorrCoef", {"num_labels": L}, "multilabel"),
    ("BinaryJaccardIndex", {}, "binary"),
    ("MulticlassJaccardIndex", {"num_classes": C, "ignore_index": 3}, "multiclass"),
    ("MulticlassJaccardIndex", {"num_classes": C, "average": "weighted"}, "multiclass"),
    ("MultilabelJaccardIndex", {"num_labels": L, "average": "micro"}, "multilabel"),
]


def _task_batch(task, seed):
    if task == "binary":
        return _binary(seed, logits=seed % 2 == 0, ignore_index=-1 if seed % 3 == 0 else None)
    if task == "multiclass":
        return _multiclass(seed, ignore_index=3 if seed % 3 == 0 else None)
    return _binary(seed, shape=(N, L), logits=seed % 2 == 0)


@pytest.mark.parametrize("name,kwargs,task", MODULAR, ids=[f"{m[0]}-{i}" for i, m in enumerate(MODULAR)])
def test_metric_multi_batch_parity(name, kwargs, task):
    jm, tm = _classes(name, **kwargs)
    for seed in range(3):
        (jp, jt), (tp, tt) = _both(*_task_batch(task, seed))
        jm.update(jp, jt)
        tm.update(tp, tt)
    _assert_equal_counts(tm.metric_state["confmat"], jm.metric_state["confmat"])
    want, got = jm.compute(), tm.compute()
    (_assert_equal_counts if got.dtype == torch.int32 else _assert_close)(got, want)
    # forward: the batch value, and the batch merged into the running state
    (jp, jt), (tp, tt) = _both(*_task_batch(task, 5))
    batch_want, batch_got = jm(jp, jt), tm(tp, tt)
    (_assert_equal_counts if batch_got.dtype == torch.int32 else _assert_close)(batch_got, batch_want)
    _assert_equal_counts(tm.metric_state["confmat"], jm.metric_state["confmat"])


@pytest.mark.parametrize("name,kwargs,task", MODULAR[:5], ids=[m[0] for m in MODULAR[:5]])
def test_state_from_jax_round_trip(name, kwargs, task):
    jm, tm = _classes(name, **kwargs)
    state = jm.init_state()
    for seed in range(2):
        (jp, jt), _ = _both(*_task_batch(task, seed))
        state = jm.update_state(state, jp, jt)
    loaded = state_from_jax(tm, _state_np(state))
    assert loaded["confmat"].dtype == torch.int32
    _assert_equal_counts(loaded["confmat"], state["confmat"])
    want, got = jm.compute_state(state), tm.compute_state(loaded)
    (_assert_equal_counts if got.dtype == torch.int32 else _assert_close)(got, want)


def test_multiclass_update_adds_in_place():
    metric = tc.MulticlassConfusionMatrix(num_classes=C, **CPU)
    preds, target = _multiclass(41)
    state = metric.init_state()
    new = metric.update_state(state, torch.from_numpy(preds), torch.from_numpy(target))
    assert new["confmat"] is state["confmat"] and int(new["confmat"].sum()) == N
    assert int(metric.init_state()["confmat"].sum()) == 0  # the defaults are untouched


WRAPPERS = [
    ("ConfusionMatrix", ["binary", "multiclass", "multilabel"]),
    ("CohenKappa", ["binary", "multiclass"]),
    ("MatthewsCorrCoef", ["binary", "multiclass", "multilabel"]),
    ("JaccardIndex", ["binary", "multiclass", "multilabel"]),
]


@pytest.mark.parametrize("name,tasks", WRAPPERS, ids=[w[0] for w in WRAPPERS])
def test_task_wrappers_build_the_jax_classes(name, tasks):
    kw = {"num_classes": C, "threshold": 0.5, **({"num_labels": L} if "multilabel" in tasks else {})}
    for task in tasks:
        want = type(getattr(jc, name)(task=task, **kw)).__name__
        got = getattr(tc, name)(task=task, **kw, **CPU)
        assert type(got).__name__ == want
    with pytest.raises(ValueError):
        getattr(tc, name)(task="regression", **CPU)
    if "multilabel" not in tasks:
        with pytest.raises(ValueError):
            getattr(tc, name)(task="multilabel", num_labels=L, **CPU)


def test_pickle_round_trip():
    metric = tc.MulticlassJaccardIndex(num_classes=C, ignore_index=3, **CPU)
    preds, target = _multiclass(42, ignore_index=3)
    metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    clone = pickle.loads(pickle.dumps(metric))
    assert torch.equal(clone.metric_state["confmat"], metric.metric_state["confmat"])
    assert torch.equal(clone.compute(), metric.compute())


def _confmat_collection(cls, collections, **device):
    return collections.MetricCollection({
        "cm": cls.MulticlassConfusionMatrix(num_classes=C, **device),
        "kappa": cls.MulticlassCohenKappa(num_classes=C, **device),
        "mcc": cls.MulticlassMatthewsCorrCoef(num_classes=C, **device),
        "iou": cls.MulticlassJaccardIndex(num_classes=C, **device),
        "recall": cls.MulticlassRecall(num_classes=C, **device),
    })


def test_collection_merges_the_confmat_metrics_into_one_group():
    jcoll, tcoll = _confmat_collection(jc, jcol), _confmat_collection(tc, tcol, **CPU)
    for seed in range(3):
        (jp, jt), (tp, tt) = _both(*_multiclass(seed))
        jcoll.update(jp, jt)
        tcoll.update(tp, tt)
    groups = sorted(sorted(g) for g in tcoll.compute_groups.values())
    assert groups == sorted(sorted(g) for g in jcoll.compute_groups.values())
    assert ["cm", "iou", "kappa", "mcc"] in groups
    leader = tcoll[next(g[0] for g in tcoll.compute_groups.values() if "cm" in g)]
    assert all(tcoll[k].metric_state is leader.metric_state for k in ("cm", "iou", "kappa", "mcc"))
    want, got = jcoll.compute(), tcoll.compute()
    for k in want:
        (_assert_equal_counts if got[k].dtype == torch.int32 else _assert_close)(got[k], want[k])


# ------------------------------------------------------------------ kernel
def test_plan_modes():
    sms = 132
    assert kcm.plan(1024, 1000, 1, 1000, False, sms) == kcm.Plan("rows", False, 256, 128)  # ImageNet-1k
    segmentation = kcm.plan(2 * 1024 * 2048, 19, 1024 * 2048, 19, False, sms)  # Cityscapes-shaped
    assert segmentation == kcm.Plan("elements", True, 8 * sms, 256)
    assert kcm.plan(100, 3, 1, 3, False, sms).mode == "elements"  # few classes: a thread a row
    assert kcm.plan(100, 1, 1, 91, True, sms) == kcm.Plan("labels", False, 1, 256)  # 91*91 cells > 32 KB
    # the shared histogram only where the batch has as many elements as the histogram has cells
    assert kcm.plan(1024, 1, 1, 42, True, sms) == kcm.Plan("labels", False, 4, 256)  # nominal's: 1,024 < 42*42
    assert kcm.plan(50_000, 1, 1, 1000, True, sms) == kcm.Plan("labels", False, 196, 256)  # clustering's
    assert kcm.plan(8100, 1, 1, 90, True, sms) == kcm.Plan("labels", True, 32, 256)
    assert kcm.plan(8099, 1, 1, 90, True, sms).shared is False
    assert kcm.plan(1024, 32, 1, 32, False, sms) == kcm.Plan("rows", True, 256, 128)  # 1,024 rows, 32*32 cells
    assert kcm.plan(1023, 32, 1, 32, False, sms).shared is False
    assert kcm.plan(10**9, 1, 1, 5, True, sms) == kcm.Plan("labels", True, 8 * sms, 256)


# A numpy model of csrc/confmat.cu's split of the work, held against jnp.argmax and JAX's _weighted_pair_count.
INT_MAX = 2**31 - 1


def _pair_cell_model(t, p, c, ignore_index):
    """The kernel's ``pair_cell``: int32 ``t * C + p`` wrapping, one wrap of a negative index, -1 where JAX adds
    nothing; ``t`` counts as its low 32 bits."""
    t32 = np.asarray(t, np.int64).astype(np.int32)
    i = (t32.astype(np.uint32) * np.uint32(c) + np.asarray(p, np.int64).astype(np.int32).astype(np.uint32))
    i = i.astype(np.int32).astype(np.int64)
    i = np.where(i < 0, i + c * c, i)
    keep = (i >= 0) & (i < c * c)
    if ignore_index is not None:
        keep &= t32.astype(np.int64) != ignore_index
    return np.where(keep, i, -1)


def _beats(a, ia, b, ib):
    na, nb = np.isnan(a), np.isnan(b)
    return np.where(na | nb, na & (~nb | (ia < ib)), (a > b) | ((a == b) & (ia < ib)))


def _rows_argmax_model(scores, width):
    """The rows kernel: 32 lanes a row, a lane's 16-byte vectors of ``width`` scores (1: scores at stride 32) taken
    in order (the first NaN, else a strictly larger value, wins), then five butterfly shuffles under ``beats``."""
    rows, k = scores.shape
    best = np.full((rows, 32), -np.inf, np.float32)
    arg = np.full((rows, 32), INT_MAX, np.int64)
    lane = np.arange(32)
    for j in range(0, -(-k // width), 32):  # a lane's vectors j + lane, in order
        for q in range(width):
            idx = (j + lane) * width + q
            live = idx < k
            v = scores[:, np.minimum(idx, k - 1)]
            take = live & ~np.isnan(best) & (np.isnan(v) | (v > best) | (arg == INT_MAX))
            best, arg = np.where(take, v, best), np.where(take, idx, arg)
    for offset in (16, 8, 4, 2, 1):
        ob, oa = best[:, lane ^ offset], arg[:, lane ^ offset]
        win = _beats(ob, oa, best, arg)
        best, arg = np.where(win, ob, best), np.where(win, oa, arg)
    assert (arg == arg[:, :1]).all()  # every lane ends on the same winner
    return arg[:, 0]


def _edge_rows(rng, n, c):
    """``chip_smoke._confmat_case``'s edge rows: NaN first, ties, +-0.0, all -inf, +inf."""
    x = rng.normal(size=(n, c)).astype(np.float32)
    nan, inf = np.nan, np.inf
    x[0::9] = nan
    x[1::9, c // 2] = nan
    x[1::9, c - 1] = nan
    x[2::9] = 0.25
    x[3::9, 0], x[3::9, c - 1] = 7.0, 7.0
    x[4::9] = -0.0
    x[4::9, c - 1] = 0.0
    x[5::9] = -inf
    x[6::9, c - 1] = inf
    x[7::9] = -inf
    x[7::9, c // 2] = nan
    return x


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("c", [6, 32, 77, 1000, 1001])
def test_rows_kernel_model_against_jax(c, dtype):
    rng = np.random.default_rng(c)
    x = _edge_rows(rng, 72, c)
    if c == 6:
        x[8] = _edge_scores(dtype)[4]  # -0.0 and +0.0 tied with a lower -0.0
    scores = torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()  # widened, as the kernel compares
    item = 4 if dtype == "float32" else 2
    width = 16 // item if (c * item) % 16 == 0 else 1  # the kernel's 16-byte loads where a row fills them
    got = _rows_argmax_model(scores, width)
    want = np.asarray(jnp.argmax(jnp.asarray(scores), axis=1))
    np.testing.assert_array_equal(got, want)
    target = rng.integers(-3, c + 3, size=72)
    target[::10] = -(c * c + 1)
    counts = np.bincount(_pair_cell_model(target, got, c, 255).clip(-1) + 1, minlength=c * c + 1)[1:]
    valid = jnp.asarray(np.where(target == 255, 0.0, 1.0), jnp.float32)
    jt = jnp.asarray(np.where(target == 255, 0, target).astype(np.int32))
    np.testing.assert_array_equal(counts.reshape(c, c), np.asarray(jcm._weighted_pair_count(
        jnp.argmax(jnp.asarray(scores), axis=1).astype(jnp.int32), jt, valid, c)).astype(np.int64))


def _add_cells_model(cells, merge):
    """The kernel's ``add_cell`` over warps of 32 lanes: with ``merge`` the lowest lane of each cell adds the count
    of its peers (``__match_any_sync``), else each lane adds one. Returns each cell's adds and the atomics made."""
    counts, atomics = collections.Counter(), 0
    for w in range(0, len(cells), 32):
        lanes = [int(c) for c in cells[w:w + 32]]
        if merge:
            for cell, peers in collections.Counter(lanes).items():
                if cell >= 0:
                    counts[cell] += peers
                    atomics += 1
        else:
            for cell in lanes:
                if cell >= 0:
                    counts[cell] += 1
                    atomics += 1
    return counts, atomics


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize(("pred_bytes", "target_bytes"), [(4, 4), (4, 8), (8, 4), (8, 8)])
@pytest.mark.parametrize("n", [1, 33, 1025])
def test_labels_kernel_model_against_jax(n, pred_bytes, target_bytes, merge):
    """A label a thread, merged in the warp (the shared histogram) or not (the state): out-of-range labels and
    targets, int64 labels past 2**32, ``ignore_index``; every element counted as JAX counts it."""
    c, ignore_index = 42, -1
    rng = np.random.default_rng(n + 3 * pred_bytes + target_bytes)
    preds = rng.integers(-3, c + 3, size=n)
    target = rng.integers(-3, c + 3, size=n)
    if n > 10:
        target[::10], preds[5::11] = -(c * c + 1), INT_MAX
        preds[1::4], target[1::4] = 7, 9  # lanes on one cell, for the merge
    if target_bytes == 8 and n > 10:
        target[3::13] += 2**32  # an int64 label counts as its low 32 bits
    counts, atomics = _add_cells_model(_pair_cell_model(target, preds, c, ignore_index), merge)
    got = np.zeros(c * c, np.int64)
    got[list(counts)] = list(counts.values())
    got = got.reshape(c, c)
    assert (atomics < got.sum()) == (merge and n > 10)  # the merge saves atomics where lanes share a cell
    t32 = target.astype(np.int32)
    valid = jnp.asarray(np.where(t32 == ignore_index, 0.0, 1.0), jnp.float32)
    want = jcm._weighted_pair_count(jnp.asarray(preds.astype(np.int32)), jnp.asarray(np.where(
        t32 == ignore_index, 0, t32)), valid, c)
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.int64))
    # and the plain version, which the kernel is held equal to on the card
    state = torch.zeros((c, c), dtype=torch.int32)
    dtypes = {4: torch.int32, 8: torch.int64}
    kcm._confmat_multiclass_plain(state, torch.from_numpy(preds).to(dtypes[pred_bytes]),
                                  torch.from_numpy(target).to(dtypes[target_bytes]), ignore_index)
    np.testing.assert_array_equal(state.numpy(), got)


def test_kernel_launcher_refuses_what_it_does_not_take():
    state = torch.zeros((C, C), dtype=torch.int32)
    preds, target = torch.rand((8, C)), torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kcm.confmat_multiclass(state, preds, target)
    with pytest.raises(ValueError, match="preds"):
        kcm.confmat_multiclass(state, preds.double(), target)
    with pytest.raises(ValueError, match="targets"):
        kcm.confmat_multiclass(state, preds, target.float())
    with pytest.raises(ValueError, match="C\\*C"):
        big = torch.empty((46341, 46341), dtype=torch.int32, device="meta")
        kcm.confmat_multiclass(big, preds.to("meta"), target.to("meta"))
    with pytest.raises(ValueError, match="2\\*\\*31 elements"):
        many = torch.empty((2**31,), dtype=torch.int32, device="meta")
        kcm.confmat_multiclass(state.to("meta"), many, many.long())
    with pytest.raises(ValueError, match="target of shape"):
        kcm.confmat_multiclass(state, preds, target[:4])
    assert kcm.confmat_multiclass.launches == 0
