"""The port's COCO mAP (``iou_type="bbox"``), held against the JAX package's.

Both backends of both packages on the same seeded images: crowds, user
areas, images without detections or ground truths, tied scores, IoUs of
exactly 1.0 (a detection that copies its ground truth). ``compute`` is host
numpy on the same float32 items, and the port's matcher (its plain version
here) equals JAX's, so every result must be exactly equal.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.detection import MeanAveragePrecision as JaxMAP
from torchmetrics_tpu.functional.detection import box_ops as jbox
from torchmetrics_tpu_torch.convert import state_from_jax
from torchmetrics_tpu_torch.detection import MeanAveragePrecision
from torchmetrics_tpu_torch.functional.detection import box_ops as tbox


def _images(seed, n_img=24, n_cls=5):
    rng = np.random.default_rng(seed)
    preds, targets = [], []
    for i in range(n_img):
        ng = int(rng.integers(0, 7))
        xy = rng.uniform(0, 300, (ng, 2))
        wh = rng.uniform(3, 150, (ng, 2))
        gb = np.round(np.concatenate([xy, xy + wh], 1)).astype(np.float32)
        gl = rng.integers(0, n_cls, ng).astype(np.int32)
        nd = int(rng.integers(0, 14))
        src = rng.integers(0, max(ng, 1), nd)
        db = (gb[src] if ng else rng.uniform(0, 200, (nd, 4)).astype(np.float32)) + rng.normal(0, 6, (nd, 4))
        db[:, 2:] = np.maximum(db[:, 2:], db[:, :2] + 1)
        dl = np.where(rng.uniform(size=nd) < 0.8, gl[src] if ng else 0, rng.integers(0, n_cls, nd)).astype(np.int32)
        scores = np.round(rng.uniform(0, 1, nd), 1).astype(np.float32)
        if ng and i % 4 == 0:  # an exact copy of a ground truth: IoU 1.0
            db = np.concatenate([db, gb[:1]])
            dl = np.concatenate([dl, gl[:1]])
            scores = np.concatenate([scores, np.float32([0.5])])
        preds.append({"boxes": db.astype(np.float32), "scores": scores.astype(np.float32), "labels": dl})
        target = {"boxes": gb, "labels": gl, "iscrowd": (rng.uniform(size=ng) < 0.15).astype(np.int32)}
        if i % 5 == 0:
            target["area"] = rng.uniform(100, 30000, ng).astype(np.float32)
        targets.append(target)
    return preds, targets


def _both(**kwargs):
    return JaxMAP(**kwargs), MeanAveragePrecision(device="cpu", **kwargs)


def _feed(jm, tm, preds, targets):
    jm.update([{k: jnp.asarray(v) for k, v in p.items()} for p in preds],
              [{k: jnp.asarray(v) for k, v in t.items()} for t in targets])
    tm.update([{k: torch.from_numpy(v) for k, v in p.items()} for p in preds],
              [{k: torch.from_numpy(v) for k, v in t.items()} for t in targets])


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)


@pytest.mark.parametrize("average", ["macro", "micro"])
@pytest.mark.parametrize("backend", ["native", "native_numpy"])
def test_map_parity(backend, average):
    jm, tm = _both(backend=backend, average=average, class_metrics=True)
    for seed in range(2):
        _feed(jm, tm, *_images(seed))
    _assert_equal(tm.compute(), jm.compute())


def test_backends_agree_and_custom_thresholds():
    kwargs = dict(iou_thresholds=[0.3, 0.5, 1.0], rec_thresholds=[0.0, 0.5, 1.0], max_detection_thresholds=[1, 3, 5])
    jm, tm = _both(**kwargs)
    tn = MeanAveragePrecision(device="cpu", backend="native_numpy", **kwargs)
    preds, targets = _images(7)
    _feed(jm, tm, preds, targets)
    tn.update([{k: torch.from_numpy(v) for k, v in p.items()} for p in preds],
              [{k: torch.from_numpy(v) for k, v in t.items()} for t in targets])
    _assert_equal(tm.compute(), jm.compute())
    _assert_equal(tn.compute(), jm.compute())


@pytest.mark.parametrize("fmt", ["xywh", "cxcywh"])
def test_box_formats(fmt):
    preds, targets = _images(3, n_img=8)
    conv = lambda b: np.asarray(jbox.box_convert(jnp.asarray(b), "xyxy", fmt))  # noqa: E731
    preds = [dict(p, boxes=conv(p["boxes"]).astype(np.float32)) for p in preds]
    targets = [dict(t, boxes=conv(t["boxes"]).astype(np.float32)) for t in targets]
    jm, tm = _both(box_format=fmt)
    _feed(jm, tm, preds, targets)
    _assert_equal(tm.compute(), jm.compute())


def test_box_ops_equal_jax():
    rng = np.random.default_rng(1)
    a = np.abs(rng.normal(size=(6, 4)) * 50).astype(np.float32)
    a[:, 2:] += a[:, :2]
    b = a[::-1].copy() + 3
    for fmt in ("xywh", "cxcywh"):
        np.testing.assert_allclose(tbox.box_convert(torch.from_numpy(a), "xyxy", fmt).numpy(),
                                   np.asarray(jbox.box_convert(jnp.asarray(a), "xyxy", fmt)), rtol=1e-6)
        np.testing.assert_allclose(tbox.box_convert(torch.from_numpy(a), fmt, "xyxy").numpy(),
                                   np.asarray(jbox.box_convert(jnp.asarray(a), fmt, "xyxy")), rtol=1e-6)
    np.testing.assert_allclose(tbox.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jbox.box_iou(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    np.testing.assert_array_equal(tbox.box_area(torch.from_numpy(a)).numpy(), np.asarray(jbox.box_area(jnp.asarray(a))))


def test_states_equal_and_carry_from_jax():
    jm, tm = _both()
    preds, targets = _images(11, n_img=6)
    _feed(jm, tm, preds, targets)
    for name, want in jm.metric_state.items():
        got = tm.metric_state[name]
        if name == "_n":
            assert int(got) == int(want)
            continue
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert g.numpy().dtype == np.asarray(w).dtype, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np_state = {k: (list(map(np.asarray, v)) if isinstance(v, tuple) else np.asarray(v))
                for k, v in jm.metric_state.items()}
    _assert_equal(tm.compute_state(state_from_jax(tm, np_state)), jm.compute())


def test_empty_and_unported_options():
    tm = MeanAveragePrecision(device="cpu")
    out = tm.compute_state(tm.init_state())
    assert float(out["map"]) == -1.0 and out["classes"].numel() == 0
    # segm, both types and extended_summary are ported: they construct, and an empty state computes as bbox's
    for kwargs, key in (({"iou_type": "segm"}, "map"), ({"extended_summary": True}, "precision"),
                        ({"iou_type": ("bbox", "segm")}, "segm_map")):
        metric = MeanAveragePrecision(device="cpu", **kwargs)
        empty = metric.compute_state(metric.init_state())
        assert key in empty and empty["classes"].numel() == 0
    # sketch mode is ported for boxes; masks with it stay refused, as in JAX
    assert "score_hist_tp" in MeanAveragePrecision(device="cpu", approx="sketch")._defaults
    with pytest.raises(ValueError, match="bbox"):
        MeanAveragePrecision(device="cpu", iou_type="segm", approx="sketch")
    with pytest.raises(ValueError):
        MeanAveragePrecision(device="cpu", backend="pycocotools")
    with pytest.raises(ValueError):
        tm.update([{"boxes": torch.zeros((0, 4)), "labels": torch.zeros(0)}], [{"boxes": torch.zeros((0, 4)), "labels": torch.zeros(0)}])
