"""Parity of the port's metric arithmetic (``CompositionalMetric``) with the JAX package.

Every operator dunder of ``Metric`` builds a lazy composition whose value is
the operator applied to its operands' values. The same seeded numpy batches
go through a JAX and a port metric of each operand; the composed values are
float32 arithmetic on float32 metric values, equal within ``rtol=1e-6,
atol=1e-7``, and integer ones exactly equal.
"""

import operator

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu.collections as jcol
import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.collections as tcol
from torchmetrics_tpu_torch.core.composition import CompositionalMetric

RTOL, ATOL = 1e-6, 1e-7
C, N = 4, 40
CPU = {"device": "cpu"}


def _batch(seed):
    rng = np.random.default_rng(seed)
    scores = rng.random((N, C)).astype(np.float32)
    return scores / scores.sum(1, keepdims=True), rng.integers(0, C, size=N).astype(np.int32)


def _update(metric, batches, to):
    for preds, target in batches:
        metric.update(to(preds), to(target))
    return metric


def _pair(name, **kwargs):
    """A JAX and a port metric of one class, updated with the same two batches."""
    batches = [_batch(0), _batch(1)]
    jm = _update(getattr(jc, name)(**kwargs), batches, jnp.asarray)
    tm = _update(getattr(tc, name)(**kwargs, **CPU), batches, torch.from_numpy)
    return jm, tm


def _assert_value(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(got.astype(want.dtype), want)


FLOAT_OPS = ["add", "sub", "mul", "truediv", "floordiv", "mod", "pow", "eq", "ne", "lt", "le", "gt", "ge"]
INT_OPS = ["and_", "or_", "xor"]


def _operands(kind):
    if kind == "float":  # two float32 scalars
        return _pair("MulticlassAccuracy", num_classes=C, average="micro"), _pair("MulticlassPrecision",
                                                                                  num_classes=C)
    return _pair("MulticlassStatScores", num_classes=C, average="micro"), _pair("MulticlassStatScores",
                                                                                num_classes=C, average="micro",
                                                                                ignore_index=0)


@pytest.mark.parametrize("side", ["metric-metric", "metric-scalar", "scalar-metric"])
@pytest.mark.parametrize("op", FLOAT_OPS + INT_OPS)
def test_binary_operators(op, side):
    (ja, ta), (jb, tb) = _operands("int" if op in INT_OPS else "float")
    fn = getattr(operator, op)
    scalar = 3 if op in INT_OPS else 2.0
    if side == "metric-metric":
        want, got = fn(ja, jb), fn(ta, tb)
    elif side == "metric-scalar":
        want, got = fn(ja, scalar), fn(ta, scalar)
    else:  # reversed: the scalar's operator defers to the metric's __r*__ (comparisons flip)
        want, got = fn(scalar, ja), fn(scalar, ta)
    assert isinstance(got, CompositionalMetric)
    _assert_value(got.compute(), want.compute())


@pytest.mark.parametrize("side", ["metric-metric", "scalar-metric"])
def test_matmul(side):
    (ja, ta), (jb, tb) = _pair("MulticlassRecall", num_classes=C, average="none"), _pair(
        "MulticlassPrecision", num_classes=C, average="none")
    if side == "metric-metric":
        want, got = ja @ jb, ta @ tb
    else:
        vec = np.arange(C, dtype=np.float32)
        want, got = jnp.asarray(vec) @ ja, torch.from_numpy(vec) @ ta
    _assert_value(got.compute(), want.compute())


@pytest.mark.parametrize("op", ["neg", "pos", "abs", "invert", "getitem"])
def test_unary_operators(op):
    if op == "invert":
        (ja, ta), _ = _operands("int")
    else:
        ja, ta = _pair("MulticlassRecall", num_classes=C, average="none")
    if op == "getitem":
        want, got = ja[1], ta[1]
    else:
        fn = {"neg": operator.neg, "pos": operator.pos, "abs": abs, "invert": operator.invert}[op]
        want, got = fn(ja), fn(ta)
    _assert_value(got.compute(), want.compute())


def test_pos_is_abs():
    _, ta = _pair("MulticlassAccuracy", num_classes=C, average="micro")
    neg = -ta
    assert float((+neg).compute()) == pytest.approx(float(ta.compute()))
    assert (+ta).op is torch.abs


def test_top1_error_update_forward_reset_compute():
    jm = 1 - jc.MulticlassAccuracy(num_classes=C, average="micro")
    tm = 1 - tc.MulticlassAccuracy(num_classes=C, average="micro", **CPU)
    assert not tm.update_called
    for seed in range(3):
        preds, target = _batch(seed)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert tm.update_called
    _assert_value(tm.compute(), jm.compute())
    preds, target = _batch(7)
    _assert_value(tm(torch.from_numpy(preds), torch.from_numpy(target)), jm(jnp.asarray(preds), jnp.asarray(target)))
    _assert_value(tm.compute(), jm.compute())  # the forward's batch went into the running state
    tm.reset()
    assert not tm.metric_b.update_called
    tm.persistent(True)
    assert all(tm.metric_b._persistent.values())


def test_composition_of_compositions_and_kwargs_filtering():
    jacc = jc.MulticlassAccuracy(num_classes=C, average="micro")
    tacc = tc.MulticlassAccuracy(num_classes=C, average="micro", **CPU)
    jf1 = jc.MulticlassF1Score(num_classes=C)
    tf1 = tc.MulticlassF1Score(num_classes=C, **CPU)
    jm, tm = (jacc + jf1) / 2, (tacc + tf1) / 2
    preds, target = _batch(3)
    jm.update(preds=jnp.asarray(preds), target=jnp.asarray(target))
    tm.update(preds=torch.from_numpy(preds), target=torch.from_numpy(target))
    _assert_value(tm.compute(), jm.compute())
    assert "true_divide" in repr(tm) and "MulticlassAccuracy" in repr(tm)


def test_metrics_stay_hashable_with_eq_defined():
    a = tc.MulticlassAccuracy(num_classes=C, **CPU)
    b = tc.MulticlassAccuracy(num_classes=C, **CPU)
    assert isinstance(a == b, CompositionalMetric)  # `==` composes, as in the JAX package
    assert hash(a) != hash(b)
    assert len({a, b, a}) == 2
    table = {a: "a", b: "b"}
    assert table[a] == "a" and table[b] == "b"
    assert hash(a) == hash(a)


def _collection(cls, collections, **device):
    return collections.MetricCollection({
        "acc": cls.MulticlassAccuracy(num_classes=C, average="micro", **device),
        "prec": cls.MulticlassPrecision(num_classes=C, average="micro", **device),
        "f1": cls.MulticlassF1Score(num_classes=C, **device),
        "cm": cls.MulticlassConfusionMatrix(num_classes=C, **device),
    })


def test_collection_compute_groups_still_merge():
    jcoll, tcoll = _collection(jc, jcol), _collection(tc, tcol, **CPU)
    for seed in range(3):
        preds, target = _batch(seed)
        jcoll.update(jnp.asarray(preds), jnp.asarray(target))
        tcoll.update(torch.from_numpy(preds), torch.from_numpy(target))
    groups = sorted(sorted(g) for g in tcoll.compute_groups.values())
    assert groups == sorted(sorted(g) for g in jcoll.compute_groups.values())
    assert ["acc", "f1", "prec"] in groups
    want, got = jcoll.compute(), tcoll.compute()
    assert set(got) == set(want)
    for k in want:
        _assert_value(got[k], want[k])
