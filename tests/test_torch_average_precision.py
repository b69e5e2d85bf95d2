"""The port's exact precision-recall curve and average precision, held against the JAX package.

The same numpy inputs go through both packages: ties inside and across
rows, logits (softmax-normalized by both), ``ignore_index`` (zero weights),
several updates. Curves: precision and recall ``rtol=1e-6, atol=1e-7``,
thresholds exact (both sort the same float32 scores stably), except after a
softmax, which the two packages round differently in the last bit. AP
``rtol=1e-5, atol=1e-6``: per-class sums of float32 products in another
order than XLA's. The binned AP shares the ``(T, C, 2, 2)`` state with
AUROC; it is checked the same way.
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu_torch.convert import state_from_jax

# the JAX package's `functional.classification` exports functions of the modules' names
jfa = importlib.import_module("torchmetrics_tpu.functional.classification.average_precision")
jfp = importlib.import_module("torchmetrics_tpu.functional.classification.precision_recall_curve")
tfa = importlib.import_module("torchmetrics_tpu_torch.functional.classification.average_precision")
tfp = importlib.import_module("torchmetrics_tpu_torch.functional.classification.precision_recall_curve")

C = 5
CURVE_TOL = dict(rtol=1e-6, atol=1e-7)
AP_TOL = dict(rtol=1e-5, atol=1e-6)


def _batch(seed, n=40, logits=False, ties=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, C)).astype(np.float32)
    if ties:  # scores rounded to a coarse grid: many ties in every class
        x = np.round(x, 1)
    if not logits:
        x = np.exp(x) / np.exp(x).sum(1, keepdims=True)
        if ties:
            x = np.round(x, 2)
    return x.astype(np.float32), rng.integers(0, C, n).astype(np.int32)


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_binary_clf_curve_exact(ties, weights):
    rng = np.random.default_rng(3)
    p = rng.uniform(size=60).astype(np.float32)
    if ties:
        p = np.round(p, 1)
    t = rng.integers(0, 2, 60).astype(np.int32)
    w = (rng.uniform(size=60) > 0.2).astype(np.float32) if weights else None
    want = jfp._binary_clf_curve(jnp.asarray(p), jnp.asarray(t), None if w is None else jnp.asarray(w))
    got = tfp._binary_clf_curve(torch.from_numpy(p), torch.from_numpy(t), None if w is None else torch.from_numpy(w))
    for g, wa in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wa))
    want = jfp._binary_precision_recall_curve_compute_exact(
        jnp.asarray(p), jnp.asarray(t), jnp.ones(60) if w is None else jnp.asarray(w))
    got = tfp._binary_precision_recall_curve_compute_exact(
        torch.from_numpy(p), torch.from_numpy(t), torch.ones(60) if w is None else torch.from_numpy(w))
    for g, wa in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wa), **CURVE_TOL)


def test_batched_curves_equal_one_curve_at_a_time():
    p, t = _batch(4)
    w = torch.ones(p.shape[0])
    pt = torch.from_numpy(p)
    for lo, hi, (prec, rec, thr) in tfp._exact_column_curves(pt, torch.from_numpy(t), w):
        for i, c in enumerate(range(lo, hi)):
            one = tfp._binary_precision_recall_curve_compute_exact(pt[:, c], torch.from_numpy((t == c).astype(np.int32)), w)
            for batched, single in zip((prec[i], rec[i], thr[i]), one):
                assert torch.equal(batched, single)


@pytest.mark.parametrize("ignore_index", [None, 2])
@pytest.mark.parametrize("logits", [False, True])
def test_multiclass_pr_curve_exact_parity(logits, ignore_index):
    jm = jc.MulticlassPrecisionRecallCurve(num_classes=C, thresholds=None, ignore_index=ignore_index)
    tm = tc.MulticlassPrecisionRecallCurve(num_classes=C, thresholds=None, ignore_index=ignore_index, device="cpu")
    for seed in range(3):
        p, t = _batch(seed, logits=logits)
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    got, want = tm.compute(), jm.compute()
    for part, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w) == C
        for gc, wc in zip(g, w):
            if part == 2 and not logits:  # softmax rounds differently in the two packages
                np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
            else:
                np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **CURVE_TOL)


@pytest.mark.parametrize("average", ["macro", "weighted", None])
@pytest.mark.parametrize("ignore_index", [None, 1])
@pytest.mark.parametrize("thresholds", [None, 20, [0.9, 0.1, 0.5, 0.3]], ids=["exact", "grid20", "list"])
def test_multiclass_average_precision_parity(thresholds, ignore_index, average):
    jm = jc.MulticlassAveragePrecision(num_classes=C, thresholds=thresholds, ignore_index=ignore_index, average=average)
    tm = tc.MulticlassAveragePrecision(num_classes=C, thresholds=thresholds, ignore_index=ignore_index,
                                       average=average, device="cpu")
    for seed in range(3):
        p, t = _batch(10 + seed, logits=seed == 1)
        jm.update(jnp.asarray(p), jnp.asarray(t))
        tm.update(torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_allclose(tm.compute().numpy(), np.asarray(jm.compute()), **AP_TOL)


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
@pytest.mark.parametrize("thresholds", [None, 20])
def test_functional_average_precision_parity(thresholds, average):
    p, t = _batch(21)
    want = jfa.multiclass_average_precision(jnp.asarray(p), jnp.asarray(t), C, average=average, thresholds=thresholds)
    got = tfa.multiclass_average_precision(torch.from_numpy(p), torch.from_numpy(t), C, average=average,
                                           thresholds=thresholds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **AP_TOL)


@pytest.mark.parametrize("thresholds", [None, 20])
def test_binary_ap_compute_parity(thresholds):
    rng = np.random.default_rng(5)
    p = np.round(rng.uniform(size=50), 1).astype(np.float32)
    t = rng.integers(0, 2, 50).astype(np.int32)
    w = (rng.uniform(size=50) > 0.1).astype(np.float32)
    thr = None if thresholds is None else np.linspace(0, 1, thresholds, dtype=np.float32)
    want = jfa._binary_ap_compute(jnp.asarray(p), jnp.asarray(t), jnp.asarray(w), None if thr is None else jnp.asarray(thr))
    got = tfa._binary_ap_compute(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(w),
                                 None if thr is None else torch.from_numpy(thr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **AP_TOL)


def test_exact_blocks_cover_every_class(monkeypatch):
    """The exact curves are sorted in blocks of classes; a small block gives the same APs."""
    p, t = _batch(30, n=64)
    args = (torch.from_numpy(p), torch.from_numpy(t), torch.ones(64), C)
    whole = tfa._multiclass_exact_ap(*args)
    monkeypatch.setattr(tfp, "EXACT_BLOCK", 2 * 64)  # two classes a block, the last block of one
    for a, b in zip(tfa._multiclass_exact_ap(*args), whole):
        assert torch.equal(a, b)


def test_exact_state_layout_and_jax_state_carry():
    jm = jc.MulticlassAveragePrecision(num_classes=C, thresholds=None)
    tm = tc.MulticlassAveragePrecision(num_classes=C, thresholds=None, device="cpu")
    state = jm.init_state()
    for seed in range(2):
        p, t = _batch(40 + seed)
        state = jm.update_state(state, jnp.asarray(p), jnp.asarray(t))
    np_state = {k: (list(map(np.asarray, v)) if isinstance(v, tuple) else np.asarray(v)) for k, v in state.items()}
    carried = state_from_jax(tm, np_state)
    assert [x.dtype for x in carried["preds"] + carried["target"] + carried["weight"]] == [torch.float32] * 2 + [torch.int32] * 2 + [torch.float32] * 2
    assert tm._reductions["preds"].value == "cat"
    np.testing.assert_allclose(tm.compute_state(carried).numpy(), np.asarray(jm.compute_state(state)), **AP_TOL)


def test_task_wrapper_and_auroc_exact_refused():
    assert isinstance(tc.AveragePrecision(task="multiclass", num_classes=3, device="cpu"), tc.MulticlassAveragePrecision)
    assert isinstance(tc.AveragePrecision(task="binary", device="cpu"), tc.BinaryAveragePrecision)
    with pytest.raises(ValueError, match="not supported"):
        tc.AveragePrecision(task="ranking", device="cpu")
    # the exact AUROC and its sketch layout are ported; explicit thresholds beside approx="sketch" stay refused
    exact = tc.MulticlassAUROC(num_classes=3, thresholds=None, device="cpu")
    assert {exact._reductions[k].value for k in ("preds", "target", "weight")} == {"cat"}
    sketch = tc.MulticlassAUROC(num_classes=3, thresholds=None, approx="sketch", device="cpu")
    assert sketch._defaults["score_hist"].shape == (3, 2, 201) and sketch._reductions["score_hist"].bucket_op == "sum"
    with pytest.raises(ValueError, match="thresholds"):
        tc.MulticlassAUROC(num_classes=3, thresholds=10, approx="sketch", device="cpu")
