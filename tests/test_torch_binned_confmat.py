"""Parity of the port's binned threshold counts and binned AUROC with the JAX package.

The CUDA kernel itself runs only on the card, where ``chip_smoke.py`` holds
it against the plain version below; in these tests the port runs on the CPU, so
``_binned_confmat_multiclass`` and the metrics' fused update
(``_binned_confmat_multiclass_accumulate``) take their plain PyTorch versions.

The threshold grid must be bit-equal to ``jnp.linspace``, and the counts are
sums of 0/1 weights: both are compared exactly. AUROC values are float32
areas summed in another order than XLA's: ``rtol=1e-5``.
"""

import hashlib
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu_torch.functional.classification import precision_recall_curve as tprc
from torchmetrics_tpu_torch.kernels import _build
from torchmetrics_tpu_torch.kernels.binned_confmat import binned_confmat_multiclass

jprc = importlib.import_module("torchmetrics_tpu.functional.classification.precision_recall_curve")

RTOL = 1e-5
C = 11


def _batch(seed, n=96, num_classes=C, ignore_index=None, logits=False):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(n, num_classes)).astype(np.float32)
    if not logits:
        scores = np.exp(scores) / np.exp(scores).sum(1, keepdims=True)
        # some scores exactly on grid points, where >= decides the bin
        scores[::7, 0] = np.asarray(jnp.linspace(0.0, 1.0, 20))[5]
    target = rng.integers(0, num_classes, size=n).astype(np.int32)
    if ignore_index is not None:
        target[rng.random(n) < 0.1] = ignore_index
    return scores.astype(np.float32), target


@pytest.mark.parametrize("num", [2, 20, 100, 200, 1000])
def test_threshold_grid_bit_equal_to_jnp_linspace(num):
    want = np.asarray(jnp.linspace(0.0, 1.0, num))
    got = tprc._adjust_threshold_arg(num, "cpu")
    assert got.dtype == torch.float32 and got.shape == (num,)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_threshold_grid_bit_equal_over_a_range():
    for num in [*range(2, 50), 255, 256, 333, 500, 1001, 4096]:
        want = np.asarray(jnp.linspace(0.0, 1.0, num))
        assert (tprc._linspace_grid(num).view(np.int32) == want.view(np.int32)).all(), num


def test_explicit_thresholds_keep_their_order():
    thr = [0.9, 0.1, 0.5]
    got = tprc._adjust_threshold_arg(thr, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jprc._adjust_threshold_arg(thr)))
    assert tprc._adjust_threshold_arg(None, "cpu") is None


def _format_both(preds, target, ignore_index):
    jp, jt, jw = jprc._multiclass_prc_format(jnp.asarray(preds), jnp.asarray(target), C, ignore_index)
    tp_, tt, tw = tprc._multiclass_prc_format(torch.from_numpy(preds), torch.from_numpy(target), C, ignore_index)
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tt.dtype == torch.int32 and tw.dtype == torch.float32
    return (jp, jt, jw), (tp_, tt, tw)


THRESHOLDS = {
    "int20": 20,
    "int100": 100,
    "unsorted": [0.5, 0.05, 0.95, 0.2, 0.0, 1.0, 0.33, 0.1, 0.75, 0.6],
}


@pytest.mark.parametrize("ignore_index", [None, 4, -1])
@pytest.mark.parametrize("thresholds", list(THRESHOLDS), ids=list(THRESHOLDS))
def test_plain_binned_confmat_exact(thresholds, ignore_index):
    thr = THRESHOLDS[thresholds]
    preds, target = _batch(len(thresholds), ignore_index=ignore_index)
    (jp, jt, jw), (tp_, tt, tw) = _format_both(preds, target, ignore_index)
    if ignore_index is not None:
        assert (tw.numpy() == 0).any()
    want = np.asarray(jprc._binned_confmat_multiclass(jp, jt, jw, jprc._adjust_threshold_arg(thr), C))
    # feed both the same formatted probs, so only the counting is compared
    tp_ = torch.from_numpy(np.array(jp))
    t_thr = tprc._adjust_threshold_arg(thr, "cpu")
    got = tprc._binned_confmat_multiclass_plain(tp_, tt, tw, t_thr, C)
    assert got.shape == want.shape == (t_thr.shape[0], C, 2, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    # on a CPU tensor the dispatching wrapper takes the plain version, and never launches the kernel
    launches = binned_confmat_multiclass.launches
    np.testing.assert_array_equal(tprc._binned_confmat_multiclass(tp_, tt, tw, t_thr, C).numpy(), want)
    assert binned_confmat_multiclass.launches == launches


def test_kernel_launcher_refuses_cpu_tensors():
    preds, target = _batch(1)
    thr, order = tprc._sort_thresholds(torch.linspace(0, 1, 5))
    state = torch.zeros((5, C, 2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        binned_confmat_multiclass(
            state, torch.from_numpy(preds), torch.from_numpy(target), torch.ones(len(target)), thr, order
        )


def test_build_keys_library_by_source_and_needs_nvcc(monkeypatch, tmp_path):
    path = _build.library_path("binned_confmat")
    assert path.parent == _build.BUILD_DIR and path == _build.library_path("binned_confmat")
    assert path.name.startswith("libbinned_confmat-") and path.suffix == ".so"
    # keyed by the source as it is now: the fused update's entry point, and no other
    source = (_build.CSRC_DIR / "binned_confmat.cu").read_bytes()
    digest = hashlib.sha256(source)
    digest.update(" ".join(_build.NVCC_FLAGS).encode())
    assert path.name == f"libbinned_confmat-{digest.hexdigest()[:16]}.so"
    assert b"binned_confmat_multiclass_launch" in source and b"binned_epilogue_kernel" in source
    changed = tmp_path / "binned_confmat.cu"
    changed.write_bytes(source + b"\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    assert _build.library_path("binned_confmat") != path
    monkeypatch.setenv("CUDA_HOME", "")
    monkeypatch.setenv("CUDA_PATH", "")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(_build.BUILD_DIR / "no-such-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["binned_confmat"])


def _state_np(state):
    return {k: np.asarray(v) for k, v in state.items()}


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, 2])
def test_multiclass_auroc_multi_batch_parity(ignore_index, average):
    jm = jc.MulticlassAUROC(num_classes=C, thresholds=20, average=average, ignore_index=ignore_index)
    tm = tc.MulticlassAUROC(num_classes=C, thresholds=20, average=average, ignore_index=ignore_index, device="cpu")
    js, ts = jm.init_state(), tm.init_state()
    for seed in range(4):
        preds, target = _batch(30 + seed, ignore_index=ignore_index)
        js = jm.update_state(js, jnp.asarray(preds), jnp.asarray(target))
        ts = tm.update_state(ts, torch.from_numpy(preds), torch.from_numpy(target))
    want_state = _state_np(js)
    assert set(ts) == set(want_state)
    for k, w in want_state.items():
        assert ts[k].numpy().dtype == w.dtype == np.int32, k
        np.testing.assert_array_equal(ts[k].numpy(), w)
    assert ts["confmat"].shape == (20, C, 2, 2)
    np.testing.assert_allclose(tm.compute_state(ts).numpy(), np.asarray(jm.compute_state(js)), rtol=RTOL)


def test_multiclass_auroc_unsorted_thresholds_and_logits():
    thr = THRESHOLDS["unsorted"]
    jm = jc.MulticlassAUROC(num_classes=C, thresholds=thr, average="none")
    tm = tc.MulticlassAUROC(num_classes=C, thresholds=thr, average="none", device="cpu")
    preds, target = _batch(77, logits=True)
    jm.update(jnp.asarray(preds), jnp.asarray(target))
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    np.testing.assert_array_equal(tm.metric_state["confmat"].numpy(), np.asarray(jm.metric_state["confmat"]))
    np.testing.assert_allclose(tm.compute().numpy(), np.asarray(jm.compute()), rtol=RTOL)


def test_multiclass_pr_curve_parity():
    jm = jc.MulticlassPrecisionRecallCurve(num_classes=C, thresholds=20)
    tm = tc.MulticlassPrecisionRecallCurve(num_classes=C, thresholds=20, device="cpu")
    for seed in range(2):
        preds, target = _batch(50 + seed)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    for g, w in zip(tm.compute(), jm.compute()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


def test_exact_layout_not_ported():
    # the exact layout is ported (cat states), and its sketch replacement; the sketch refuses explicit thresholds
    assert "confmat" not in tc.MulticlassAUROC(num_classes=C, device="cpu")._defaults
    assert set(tc.MulticlassAUROC(num_classes=C, approx="sketch", device="cpu")._defaults) == {"score_hist"}
    with pytest.raises(ValueError, match="thresholds"):
        tc.MulticlassAUROC(num_classes=C, thresholds=20, approx="sketch", device="cpu")
    with pytest.raises(ValueError):
        tc.MulticlassAUROC(num_classes=C, thresholds=1, device="cpu")
    with pytest.raises(ValueError):
        tc.MulticlassAUROC(num_classes=C, thresholds="20", device="cpu")


OUT_OF_RANGE = {"C": C, "C+3": C + 3, "-3": -3}


@pytest.mark.parametrize("ignore_index", [None, -3])
@pytest.mark.parametrize("metric", ["MulticlassAUROC", "MulticlassPrecisionRecallCurve"])
def test_out_of_range_targets_are_negatives_as_in_jax(metric, ignore_index):
    """A target outside ``[0, C)`` that is not ``ignore_index`` is a negative for every class."""
    jm = getattr(jc, metric)(num_classes=C, thresholds=20, ignore_index=ignore_index, validate_args=False)
    tm = getattr(tc, metric)(num_classes=C, thresholds=20, ignore_index=ignore_index, validate_args=False, device="cpu")
    js, ts = jm.init_state(), tm.init_state()
    for seed in range(2):
        preds, target = _batch(90 + seed)
        for i, bad in enumerate(OUT_OF_RANGE.values()):
            target[i::7] = bad
        js = jm.update_state(js, jnp.asarray(preds), jnp.asarray(target))
        ts = tm.update_state(ts, torch.from_numpy(preds), torch.from_numpy(target))
    want = np.asarray(js["confmat"])
    assert ts["confmat"].dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(ts["confmat"].numpy(), want)
    # rows with such targets still count in every class's total
    assert int(want[0, 0].sum()) == 2 * len(target) - (0 if ignore_index is None else 2 * len(target[2::7]))
