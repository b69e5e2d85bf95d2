"""The plain version of the ``binned_confmat_multilabel`` kernel against the JAX package, and its launcher.

On the CPU the multilabel and binary binned updates are the plain PyTorch
version, the JAX package's einsum form; ``chip_smoke.py`` holds the CUDA
kernel ``torch.equal`` to it on the card. Here the plain update, old int32
state + one batch, must equal JAX's ``_binned_confmat_multilabel`` followed
by the int32 add of ``classification/precision_recall_curve.py:130``
exactly, and at one label JAX's binary ``_binned_curve_update``. The
launcher's geometry (``plan``) and its refusals run on the CPU too.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu_torch.kernels import binned_multilabel as kbm
from torchmetrics_tpu_torch.kernels.binned_multilabel import binned_confmat_multilabel

jprc = importlib.import_module("torchmetrics_tpu.functional.classification.precision_recall_curve")
tprc = importlib.import_module("torchmetrics_tpu_torch.functional.classification.precision_recall_curve")

N, L = 96, 5
NAN, INF = float("nan"), float("inf")
GRIDS = {
    "grid20": 20,
    "grid1000": 1000,
    "unsorted-dup": [0.7, 0.2, 0.2, 0.95, 0.01, 0.5, 0.5],
    "nan-inf": [0.5, NAN, 0.1, INF, -INF, 0.1, NAN, 0.0, -0.0, 1.0],
}


def _batch(seed, n=N, labels=L, edits=()):
    """A formatted batch ``(probs, target, weights)`` as numpy: sigmoid scores on a
    0.05 grid (scores on thresholds), 0/1 targets, 0/1 weights."""
    rng = np.random.default_rng(seed)
    p = np.round(rng.uniform(size=(n, labels)) / 0.05) * 0.05
    t = (rng.uniform(size=(n, labels)) < 0.3).astype(np.int32)
    w = np.ones((n, labels), np.float32)
    if "ignored" in edits:  # as _multilabel_prc_format leaves an ignored element
        ignored = rng.uniform(size=(n, labels)) < 0.15
        w[ignored], t[ignored] = 0.0, 0
    if "nonfinite" in edits:
        p[::7, 0], p[1::7, -1], p[2::11, labels // 2] = np.nan, np.inf, -np.inf
    if "no_positives" in edits:
        t[:, 0] = 0
    if "zero_weights" in edits:
        w[:] = 0.0
    return p.astype(np.float32), t, w


def _thresholds(spec):
    return jprc._adjust_threshold_arg(spec), tprc._adjust_threshold_arg(spec, "cpu")


def _state(t, labels, seed):
    return np.random.default_rng(seed).integers(-(2**20), 2**20, (t, labels, 2, 2)).astype(np.int32)


EDITS = [(), ("ignored",), ("nonfinite",), ("no_positives",), ("zero_weights",), ("ignored", "nonfinite")]


@pytest.mark.parametrize("edits", EDITS, ids=["-".join(e) or "plain" for e in EDITS])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_plain_update_equals_jax_counts_plus_int32_add(grid, edits):
    p, t, w = _batch(1, edits=edits)
    jthr, tthr = _thresholds(GRIDS[grid])
    old = _state(tthr.shape[0], L, 2)
    counts = jprc._binned_confmat_multilabel(jnp.asarray(p), jnp.asarray(t), jnp.asarray(w), jthr)
    want = jnp.asarray(old) + counts.astype(jnp.int32)
    got = tprc._binned_confmat_multilabel_accumulate_plain(
        torch.from_numpy(old), torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(w), tthr)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the dispatch takes the plain version for CPU tensors, and the per-batch counts are the JAX ones
    dispatched = tprc._binned_confmat_multilabel_accumulate(
        torch.from_numpy(old), torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(w), tthr)
    assert torch.equal(dispatched, got)
    per_batch = tprc._binned_confmat_multilabel(torch.from_numpy(p), torch.from_numpy(t), torch.from_numpy(w), tthr)
    np.testing.assert_array_equal(per_batch.numpy(), np.asarray(counts))


@pytest.mark.parametrize("edits", EDITS[:3], ids=["plain", "ignored", "nonfinite"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_one_label_is_the_binary_update(grid, edits):
    p, t, w = _batch(3, n=200, labels=1, edits=edits)
    jthr, tthr = _thresholds(GRIDS[grid])
    want = jprc._binned_curve_update(jnp.asarray(p[:, 0]), jnp.asarray(t[:, 0]), jnp.asarray(w[:, 0]), jthr)
    old = _state(tthr.shape[0], 1, 4)[:, 0]
    got = tprc._binned_curve_accumulate(torch.from_numpy(old), torch.from_numpy(p[:, 0]), torch.from_numpy(t[:, 0]),
                                        torch.from_numpy(w[:, 0]), tthr)
    np.testing.assert_array_equal(got.numpy(), old + np.asarray(want).astype(np.int32))
    per_batch = tprc._binned_curve_update(torch.from_numpy(p[:, 0]), torch.from_numpy(t[:, 0]),
                                          torch.from_numpy(w[:, 0]), tthr)
    np.testing.assert_array_equal(per_batch.numpy(), np.asarray(want))


@pytest.mark.parametrize("task", ["Binary", "Multilabel"])
def test_metric_binned_state_equals_jax(task):
    kw = {} if task == "Binary" else {"num_labels": L}
    jm = getattr(jc, f"{task}PrecisionRecallCurve")(thresholds=GRIDS["unsorted-dup"], ignore_index=-1, **kw)
    tm = getattr(tc, f"{task}PrecisionRecallCurve")(thresholds=GRIDS["unsorted-dup"], ignore_index=-1, **kw,
                                                     device="cpu")
    js, ts = jm.init_state(), tm.init_state()
    for seed in range(3):
        p, t, _ = _batch(10 + seed, edits=("nonfinite",))
        t = np.where(np.random.default_rng(seed).uniform(size=t.shape) < 0.1, -1, t)
        if task == "Binary":
            p, t = p[:, 0], t[:, 0]
        js = jm.update_state(js, jnp.asarray(p), jnp.asarray(t))
        ts = tm.update_state(ts, torch.from_numpy(p), torch.from_numpy(t))
    assert ts["confmat"].dtype == torch.int32
    np.testing.assert_array_equal(ts["confmat"].numpy(), np.asarray(js["confmat"]))


PLAN_CASES = [  # (rows, labels, thresholds, labels a group, row chunks)
    (256, 80, 100, 1, 1),  # the COCO batch: 80 blocks of one label and 256 rows
    (56, 80, 100, 1, 1),  # the last COCO batch (40,504 % 256)
    (1024, 1, 200, 1, 1),  # the binary batch at one label: one block
    (848, 1, 200, 1, 1),  # the last binary batch (50,000 % 1,024)
    (1024, 1000, 20, 7, 1),  # more labels than SMs: 143 groups of 7, the last of 6
    (200_000, 80, 100, 8, 53),  # a large batch: a sector of each row, row chunks merged by the group's last block
    (50_000, 1, 200, 1, 4),
    (256, 80, 4000, 1, 1),
    (100_000, 80, 4000, 2, 13),  # 4,001 bins: two labels' histograms fit the budget
    (256, 80, kbm.MAX_THRESHOLDS, 1, 1),  # the most thresholds: one label's 16,385 bins in one block
]


@pytest.mark.parametrize(("rows", "labels", "n_thr", "group", "chunks"), PLAN_CASES)
def test_plan(rows, labels, n_thr, group, chunks):
    geometry = kbm.plan(rows, labels, n_thr, 132)
    assert geometry.labels == group and geometry.chunks == chunks
    assert geometry.groups * group >= labels > (geometry.groups - 1) * group
    assert chunks * geometry.rows_per_chunk >= rows > (chunks - 1) * geometry.rows_per_chunk
    if chunks == 1:  # every batch of the curve paths: one block a group, no merge, no scratch
        assert rows * group <= kbm.ONE_CHUNK_ELEMENTS
    else:  # at most BLOCKS_PER_SM blocks an SM over the grid
        assert geometry.groups * chunks <= kbm.BLOCKS_PER_SM * 132 + geometry.groups
    assert group <= geometry.label_lanes <= 32 and geometry.label_lanes & (geometry.label_lanes - 1) == 0
    # every bin of a group's labels and every threshold sit in the block's shared memory, with
    # the kernel's static 2 KB, within the card's 227 KB; the epilogue's segments cover the bins
    bins = n_thr + 1
    assert geometry.shared_bytes == (2 * group * (bins | 1) + bins) * 4
    assert geometry.shared_bytes + 2048 <= 227 * 1024
    segments = kbm.THREADS // geometry.label_lanes
    assert segments * -(-bins // segments) >= bins


def _good_inputs(n=8, labels=L, t=5):
    thr, order = tprc._sort_thresholds(torch.linspace(0, 1, t))
    return {
        "confmat": torch.zeros((t, labels, 2, 2), dtype=torch.int32),
        "probs": torch.rand((n, labels)),
        "target": torch.zeros((n, labels), dtype=torch.int32),
        "weights": torch.ones((n, labels)),
        "sorted_thresholds": thr,
        "order": order,
    }


def _meta(**shapes):
    out = {k: v.to("meta") for k, v in _good_inputs().items()}
    for k, (shape, dtype) in shapes.items():
        out[k] = torch.empty(shape, dtype=dtype, device="meta")
    return out


BAD_INPUTS = {
    "cpu_tensors": (lambda: _good_inputs(), "CUDA"),
    "meta_tensors": (lambda: _meta(), "CUDA"),
    "probs_1d": (lambda: {**_good_inputs(), "probs": torch.rand((8,))}, "dims"),
    "probs_float64": (lambda: {**_good_inputs(), "probs": torch.rand((8, L), dtype=torch.float64)}, "dtype"),
    "target_per_row": (lambda: {**_good_inputs(), "target": torch.zeros((8,), dtype=torch.int32)}, "shape"),
    "target_int64": (lambda: {**_good_inputs(), "target": torch.zeros((8, L), dtype=torch.int64)}, "dtype"),
    "weights_per_row": (lambda: {**_good_inputs(), "weights": torch.ones((8,))}, "shape"),
    "weights_strided": (lambda: {**_good_inputs(), "weights": torch.ones((L, 8)).T}, "contiguous"),
    "confmat_other_labels": (lambda: {**_good_inputs(), "confmat": torch.zeros((5, L + 1, 2, 2), dtype=torch.int32)},
                             "shape"),
    "too_many_thresholds": (lambda: _meta(sorted_thresholds=((kbm.MAX_THRESHOLDS + 1,), torch.float32)),
                            "thresholds"),
    "rows_2_to_the_31": (lambda: _meta(probs=((2**31, L), torch.float32)), "2\\*\\*31"),
}


@pytest.mark.parametrize("name", list(BAD_INPUTS))
def test_launcher_refuses_before_any_build(name, monkeypatch):
    def no_build(*_):
        raise AssertionError("the launcher reached the build")

    monkeypatch.setattr(kbm, "load_library", no_build)
    make, match = BAD_INPUTS[name]
    launches = binned_confmat_multilabel.launches
    with pytest.raises(ValueError, match=match):
        binned_confmat_multilabel(**make())
    assert binned_confmat_multilabel.launches == launches


def test_no_plain_fallback_on_a_non_cpu_tensor(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel's launcher, never to the plain version."""
    monkeypatch.setattr(tprc, "_binned_confmat_multilabel_accumulate_plain",
                        lambda *a: pytest.fail("the plain version ran for a non-CPU tensor"))
    inputs = _meta()
    with pytest.raises(ValueError, match="CUDA"):
        tprc._binned_confmat_multilabel_accumulate(
            inputs["confmat"], inputs["probs"], inputs["target"], inputs["weights"],
            torch.linspace(0, 1, 5, device="meta"), (inputs["sorted_thresholds"], inputs["order"]))
