"""Parity of the port's stat-scores tower (stat scores, accuracy, F1) with the JAX package.

Inputs are made from a seed with numpy and fed to both packages; the port
runs on the CPU. Integer states and stat scores are sums of 0/1 indicators
and must be exactly equal, and int32. Scores are float32 reductions taken in
another order than XLA's: ``rtol=1e-6, atol=1e-7``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu.utilities import compute as jcompute
from torchmetrics_tpu.utilities import data as jdata
from torchmetrics_tpu_torch.utilities import compute as tcompute
from torchmetrics_tpu_torch.utilities import data as tdata

# both packages' functional namespaces re-export a function named
# `stat_scores`, which hides the module of that name from attribute imports
jfs = importlib.import_module("torchmetrics_tpu.functional.classification.stat_scores")
tfs = importlib.import_module("torchmetrics_tpu_torch.functional.classification.stat_scores")

RTOL, ATOL = 1e-6, 1e-7
C = 7


def _batch(seed, n=48, num_classes=C, ignore_index=None, logits=False):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(n, num_classes)).astype(np.float32)
    if not logits:
        scores = np.exp(scores) / np.exp(scores).sum(1, keepdims=True)
    target = rng.integers(0, num_classes, size=n).astype(np.int32)
    if ignore_index is not None:
        target[rng.random(n) < 0.2] = ignore_index
    return scores.astype(np.float32), target


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("ignore_index", [None, -1, 2])
@pytest.mark.parametrize("top_k", [1, 2])
def test_indicators_parity(top_k, ignore_index, multidim_average):
    preds, target = _batch(top_k, ignore_index=ignore_index)
    want = jfs._multiclass_indicators(jnp.asarray(preds), jnp.asarray(target), C, top_k, ignore_index)
    got = tfs._multiclass_indicators(torch.from_numpy(preds), torch.from_numpy(target), C, top_k, ignore_index)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(_np(g), _np(w))
    want_s = jfs._indicator_stat_scores(*want, multidim_average)
    got_s = tfs._indicator_stat_scores(*got, multidim_average)
    for g, w in zip(got_s, want_s):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_indicators_parity_int_preds():
    rng = np.random.default_rng(3)
    preds = rng.integers(0, C, size=(16, 5)).astype(np.int32)
    target = rng.integers(0, C, size=(16, 5)).astype(np.int32)
    want = jfs._multiclass_indicators(jnp.asarray(preds), jnp.asarray(target), C)
    got = tfs._multiclass_indicators(torch.from_numpy(preds), torch.from_numpy(target), C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("ignore_index", [None, 3])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
def test_multiclass_stat_scores_parity(average, top_k, ignore_index):
    preds, target = _batch(11, ignore_index=ignore_index)
    want = jfs.multiclass_stat_scores(jnp.asarray(preds), jnp.asarray(target), C, average, top_k, ignore_index=ignore_index)
    got = tfs.multiclass_stat_scores(torch.from_numpy(preds), torch.from_numpy(target), C, average, top_k, ignore_index=ignore_index)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _state_np(state):
    return {k: (np.asarray(v) if not isinstance(v, tuple) else [np.asarray(x) for x in v]) for k, v in state.items()}


def _assert_states_equal(torch_state, jax_state):
    assert set(torch_state) == set(jax_state)
    for k, w in _state_np(jax_state).items():
        g = torch_state[k]
        if isinstance(w, list):
            assert len(g) == len(w)
            for gi, wi in zip(g, w):
                np.testing.assert_array_equal(gi.numpy(), wi)
            continue
        assert g.numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("ignore_index", [None, 0])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("name", ["MulticlassAccuracy", "MulticlassF1Score"])
def test_metric_multi_batch_parity(name, average, ignore_index):
    jm = getattr(jc, name)(num_classes=C, average=average, ignore_index=ignore_index)
    tm = getattr(tc, name)(num_classes=C, average=average, ignore_index=ignore_index, device="cpu")
    js, ts = jm.init_state(), tm.init_state()
    for seed in range(4):
        preds, target = _batch(100 + seed, ignore_index=ignore_index, logits=seed % 2 == 1)
        js = jm.update_state(js, jnp.asarray(preds), jnp.asarray(target))
        ts = tm.update_state(ts, torch.from_numpy(preds), torch.from_numpy(target))
    _assert_states_equal(ts, js)
    for k in ("tp", "fp", "tn", "fn", "_n"):
        assert ts[k].dtype == torch.int32
    np.testing.assert_allclose(tm.compute_state(ts).numpy(), np.asarray(jm.compute_state(js)), rtol=RTOL, atol=ATOL)


def test_fbeta_and_samplewise_parity():
    jm = jc.MulticlassFBetaScore(beta=2.0, num_classes=C, average="macro", multidim_average="samplewise")
    tm = tc.MulticlassFBetaScore(beta=2.0, num_classes=C, average="macro", multidim_average="samplewise", device="cpu")
    js, ts = jm.init_state(), tm.init_state()
    for seed in range(3):
        preds, target = _batch(200 + seed, n=12)
        js = jm.update_state(js, jnp.asarray(preds), jnp.asarray(target))
        ts = tm.update_state(ts, torch.from_numpy(preds), torch.from_numpy(target))
    _assert_states_equal(ts, js)
    np.testing.assert_allclose(tm.compute_state(ts).numpy(), np.asarray(jm.compute_state(js)), rtol=RTOL, atol=ATOL)


def test_stat_scores_metric_parity():
    jm = jc.MulticlassStatScores(num_classes=C, average="none")
    tm = tc.MulticlassStatScores(num_classes=C, average="none", device="cpu")
    preds, target = _batch(5)
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    got = tm.compute()
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.compute()))


def test_logits_predicate_is_whole_tensor():
    # one row of logits outside [0, 1]: the whole batch is softmaxed, not just that row
    rng = np.random.default_rng(9)
    probs = rng.dirichlet(np.ones(C), size=6).astype(np.float32)
    probs[2] = rng.normal(scale=3.0, size=C).astype(np.float32)
    want = np.asarray(jcompute.normalize_logits_if_needed(jnp.asarray(probs), "softmax"))
    got = tcompute.normalize_logits_if_needed(torch.from_numpy(probs), "softmax").numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not np.allclose(got[0], probs[0])  # an in-range row was normalized too
    in_range = rng.dirichlet(np.ones(C), size=6).astype(np.float32)
    np.testing.assert_array_equal(tcompute.normalize_logits_if_needed(torch.from_numpy(in_range), "softmax").numpy(), in_range)


def test_sigmoid_predicate_parity():
    x = np.array([[0.2, 0.9], [1.5, 0.1]], dtype=np.float32)
    want = np.asarray(jcompute.normalize_logits_if_needed(jnp.asarray(x), "sigmoid"))
    got = tcompute.normalize_logits_if_needed(torch.from_numpy(x), "sigmoid").numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        tcompute.normalize_logits_if_needed(torch.from_numpy(x), "tanh")


@pytest.mark.parametrize("topk", [1, 2, 3])
def test_select_topk_ties(topk):
    x = np.array([[0.3, 0.3, 0.3, 0.1], [0.0, 0.5, 0.5, 0.0], [0.25, 0.25, 0.25, 0.25]], dtype=np.float32)
    want = np.asarray(jdata.select_topk(jnp.asarray(x), topk))
    got = tdata.select_topk(torch.from_numpy(x), topk)
    assert got.dtype == torch.int32
    if topk == 1:
        # ties go to the first index, as in jnp.argmax
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        # torch.topk gives no tie order: the mask holds k entries, all of the top values
        assert (got.numpy().sum(1) == topk).all()
        kth = np.sort(x, axis=1)[:, -topk][:, None]
        assert (x[got.numpy() == 1].reshape(3, topk) >= kth).all()


def test_argmax_ties_through_accuracy():
    preds = np.array([[0.5, 0.5, 0.0], [0.2, 0.4, 0.4], [0.1, 0.1, 0.8]], dtype=np.float32)
    target = np.array([1, 2, 2], dtype=np.int32)
    jm = jc.MulticlassAccuracy(num_classes=3, average="micro")
    tm = tc.MulticlassAccuracy(num_classes=3, average="micro", device="cpu")
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert float(tm.compute()) == float(jm.compute()) == pytest.approx(1 / 3)


def test_to_onehot_and_dim_zero_cat():
    labels = np.array([[0, 2], [1, 3]], dtype=np.int32)
    want = np.asarray(jdata.to_onehot(jnp.asarray(labels), 3))
    got = tdata.to_onehot(torch.from_numpy(labels), 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)  # label 3 is out of range: a row of zeros
    cat = tdata.dim_zero_cat((torch.tensor(1.0), torch.tensor([2.0, 3.0])))
    np.testing.assert_array_equal(cat.numpy(), [1.0, 2.0, 3.0])
    with pytest.raises(ValueError):
        tdata.dim_zero_cat([])


@pytest.mark.parametrize(
    "kwargs",
    [
        {"num_classes": 1},
        {"num_classes": 3, "top_k": 0},
        {"num_classes": 3, "top_k": 4},
        {"num_classes": 3, "average": "samples"},
        {"num_classes": 3, "multidim_average": "local"},
        {"num_classes": 3, "ignore_index": 1.5},
    ],
)
def test_validation_parity(kwargs):
    with pytest.raises(ValueError):
        jc.MulticlassStatScores(**kwargs)
    with pytest.raises(ValueError):
        tc.MulticlassStatScores(**kwargs, device="cpu")


def test_task_wrappers():
    assert isinstance(tc.Accuracy(task="multiclass", num_classes=3, device="cpu"), tc.MulticlassAccuracy)
    assert isinstance(tc.F1Score("multiclass", num_classes=3, device="cpu"), tc.MulticlassF1Score)
    assert isinstance(tc.FBetaScore(task="multiclass", beta=0.5, num_classes=3, device="cpu"), tc.MulticlassFBetaScore)
    assert isinstance(tc.StatScores(task="multiclass", num_classes=3, device="cpu"), tc.MulticlassStatScores)
    assert isinstance(tc.Accuracy(task="binary", device="cpu"), tc.BinaryAccuracy)
    assert isinstance(tc.Accuracy(task="multilabel", num_labels=3, device="cpu"), tc.MultilabelAccuracy)
    assert isinstance(tc.AUROC(task="binary", device="cpu"), tc.BinaryAUROC)  # the curve family has every task
    with pytest.raises(ValueError, match="not supported"):
        tc.AUROC(task="regression", device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        tc.Accuracy(task="regression", device="cpu")
    with pytest.raises(ValueError, match="beta"):
        tc.MulticlassFBetaScore(beta=0.0, num_classes=3, device="cpu")
