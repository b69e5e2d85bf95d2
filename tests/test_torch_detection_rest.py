"""The port's detection beyond bbox mAP, held against the JAX package's.

The IoU family (box functions, functionals and the four classes), mAP with
``iou_type="segm"`` and both types with ``extended_summary``, the COCO file
I/O and the panoptic qualities, on the same seeded inputs in both packages,
and a numpy model of the ``mask_iou`` kernel's algorithm against JAX's
float64 product. Tolerances: the float32 box IoUs within 1e-6 (relative and
absolute: the same formulas, XLA's and ATen's float32 rounding); mAP,
``extended_summary`` and the segm IoU matrices exactly equal (the mask IoUs
are float64 divisions of the same exact integers); RLE strings and decoded
masks byte for byte; panoptic counts exactly, float64 IoU sums within 1e-12
relative, float32 results and states within 1e-6 relative.
"""

from __future__ import annotations

import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.detection as jdet
import torchmetrics_tpu.detection.coco_io as jcoco
import torchmetrics_tpu.functional.detection.box_ops as jbox
import torchmetrics_tpu.functional.detection.iou as jiou
from torchmetrics_tpu.detection.mean_ap import _mask_iou_crowd
import torchmetrics_tpu_torch.detection as tdet
import torchmetrics_tpu_torch.detection.coco_io as tcoco
import torchmetrics_tpu_torch.functional.detection.box_ops as tbox
import torchmetrics_tpu_torch.functional.detection.iou as tiou
from torchmetrics_tpu_torch.detection.mean_ap import _mask_iou_from_counts
from torchmetrics_tpu_torch.kernels import mask_iou as kmi

# the packages export ``panoptic_quality`` the function under the module's name
jpq = importlib.import_module("torchmetrics_tpu.functional.detection.panoptic_quality")
tpq = importlib.import_module("torchmetrics_tpu_torch.functional.detection.panoptic_quality")
BOX_TOL = 1e-6


def _boxes(rng, n, degenerate=False):
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(0.5, 60, (n, 2))
    if degenerate and n > 2:
        wh[0] = 0.0  # a point
        wh[1, 1] = 0.0  # a line
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# ------------------------------------------------------------------ IoU family
@pytest.mark.parametrize("name", ["box_iou", "generalized_box_iou", "distance_box_iou", "complete_box_iou"])
@pytest.mark.parametrize("seed", [0, 1])
def test_box_functions(name, seed):
    rng = np.random.default_rng(seed)
    a, b = _boxes(rng, 9, degenerate=True), _boxes(rng, 7)
    b[2] = a[3]  # an exact copy
    want = np.asarray(getattr(jbox, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tbox, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == np.float32 and got.shape == (9, 7)
    np.testing.assert_allclose(got, want, rtol=BOX_TOL, atol=BOX_TOL)


FUNCTIONALS = ["intersection_over_union", "generalized_intersection_over_union",
               "distance_intersection_over_union", "complete_intersection_over_union"]


@pytest.mark.parametrize("name", FUNCTIONALS)
@pytest.mark.parametrize(("threshold", "aggregate"), [(None, True), (None, False), (0.4, False), (0.4, True)])
def test_iou_functionals(name, threshold, aggregate):
    rng = np.random.default_rng(3)
    a, b = _boxes(rng, 6), _boxes(rng, 6)
    b[:3] = a[:3] + rng.normal(0, 3, (3, 4)).astype(np.float32)
    kw = dict(iou_threshold=threshold, replacement_val=-0.5, aggregate=aggregate)
    want = np.asarray(getattr(jiou, name)(jnp.asarray(a), jnp.asarray(b), **kw))
    got = getattr(tiou, name)(torch.from_numpy(a), torch.from_numpy(b), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=BOX_TOL, atol=BOX_TOL)
    empty = getattr(tiou, name)(torch.zeros(0), torch.zeros((0, 4)), aggregate=aggregate)
    assert tuple(empty.shape) == (() if aggregate else (0, 0))


def _box_images(seed, n_img=6, n_cls=3, with_scores=True):
    rng = np.random.default_rng(seed)
    preds, targets = [], []
    for i in range(n_img):
        ng = 0 if i == 2 else int(rng.integers(1, 6))
        nd = 0 if i == 4 else int(rng.integers(1, 7))
        gb, db = _boxes(rng, ng), _boxes(rng, nd)
        if ng and nd:
            db[: min(ng, nd)] = gb[: min(ng, nd)] + rng.normal(0, 4, (min(ng, nd), 4)).astype(np.float32)
        p = {"boxes": db, "labels": rng.integers(0, n_cls, nd).astype(np.int32)}
        if with_scores:
            p["scores"] = rng.uniform(size=nd).astype(np.float32)
        preds.append(p)
        targets.append({"boxes": gb, "labels": rng.integers(0, n_cls, ng).astype(np.int32)})
    return preds, targets


CLASSES = ["IntersectionOverUnion", "GeneralizedIntersectionOverUnion", "DistanceIntersectionOverUnion",
           "CompleteIntersectionOverUnion"]


@pytest.mark.parametrize("name", CLASSES)
@pytest.mark.parametrize(("respect_labels", "class_metrics", "threshold"),
                         [(True, False, None), (True, True, None), (False, True, 0.3), (False, False, 0.3)])
def test_iou_classes(name, respect_labels, class_metrics, threshold):
    kw = dict(respect_labels=respect_labels, class_metrics=class_metrics, iou_threshold=threshold)
    jm, tm = getattr(jdet, name)(**kw), getattr(tdet, name)(device="cpu", **kw)
    for seed in (0, 1):
        preds, targets = _box_images(seed, with_scores=seed == 0)
        jm.update([{k: jnp.asarray(v) for k, v in p.items()} for p in preds],
                  [{k: jnp.asarray(v) for k, v in t.items()} for t in targets])
        tm.update([{k: torch.from_numpy(v) for k, v in p.items()} for p in preds],
                  [{k: torch.from_numpy(v) for k, v in t.items()} for t in targets])
    want, got = jm.compute(), tm.compute()
    assert set(got) == set(want) and (not class_metrics or len(got) > 1)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(w), rtol=BOX_TOL, atol=BOX_TOL, err_msg=key)
    for g, w in zip(tm.metric_state["iou_matrix"], jm.metric_state["iou_matrix"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=BOX_TOL, atol=BOX_TOL)


def test_iou_class_without_boxes():
    tm = tdet.IntersectionOverUnion(device="cpu", class_metrics=True)
    tm.update([{"boxes": torch.zeros((0, 4)), "labels": torch.zeros(0, dtype=torch.int32)}],
              [{"boxes": torch.zeros((0, 4)), "labels": torch.zeros(0, dtype=torch.int32)}])
    out = tm.compute()
    assert set(out) == {"iou"} and float(out["iou"]) == 0.0
    with pytest.raises(ValueError, match="boxes"):
        tm.update([{"labels": torch.zeros(0)}], [{"boxes": torch.zeros((0, 4)), "labels": torch.zeros(0)}])


# ------------------------------------------------------------------- segm mAP
def _mask_images(seed, n_img=8, n_cls=3, hw=(24, 33)):
    """Seeded images of rectangle-and-hole masks, their boxes, crowds, user areas, an image without detections
    and one without ground truths; detections near their ground truths and some copies of one."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[:h, :w]
    preds, targets = [], []

    def masks_of(boxes):
        m = np.zeros((len(boxes), h, w), bool)
        for k, (x1, y1, x2, y2) in enumerate(boxes):
            m[k] = (xx >= x1) & (xx < x2) & (yy >= y1) & (yy < y2)
            m[k] &= rng.uniform(size=(h, w)) > 0.1
        return m

    for i in range(n_img):
        ng = 0 if i == 3 else int(rng.integers(1, 6))
        nd = 0 if i == 5 else int(rng.integers(1, 9))
        gb = np.concatenate([rng.integers(0, w // 2, (ng, 1)), rng.integers(0, h // 2, (ng, 1))], 1)
        gb = np.concatenate([gb, gb + rng.integers(2, 14, (ng, 2))], 1).astype(np.float32)
        gm = masks_of(gb)
        src = rng.integers(0, max(ng, 1), nd)
        db = (gb[src] if ng else np.zeros((nd, 4), np.float32)) + rng.integers(-2, 3, (nd, 4))
        db[:, 2:] = np.maximum(db[:, 2:], db[:, :2] + 1)
        dm = masks_of(db)
        if ng and nd:
            dm[0] = gm[src[0]]  # an exact copy: IoU 1.0
        gl = rng.integers(0, n_cls, ng).astype(np.int32)
        dl = np.where(rng.uniform(size=nd) < 0.8, gl[src] if ng else 0, rng.integers(0, n_cls, nd)).astype(np.int32)
        preds.append({"boxes": db.astype(np.float32), "masks": dm, "scores": rng.uniform(size=nd).astype(np.float32),
                      "labels": dl})
        t = {"boxes": gb, "masks": gm, "labels": gl, "iscrowd": (rng.uniform(size=ng) < 0.2).astype(np.int32)}
        if i % 3 == 0:
            t["area"] = np.where(rng.uniform(size=ng) < 0.5, rng.uniform(10, 400, ng), 0.0).astype(np.float32)
        targets.append(t)
    return preds, targets


def _feed(jm, tm, preds, targets):
    jm.update([{k: jnp.asarray(v) for k, v in p.items()} for p in preds],
              [{k: jnp.asarray(v) for k, v in t.items()} for t in targets])
    tm.update([{k: torch.from_numpy(v) for k, v in p.items()} for p in preds],
              [{k: torch.from_numpy(v) for k, v in t.items()} for t in targets])


def _assert_map_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, dict):
            assert list(got[key]) == list(w), key
            for k2, w2 in w.items():
                assert got[key][k2].dtype == torch.float32
                np.testing.assert_array_equal(got[key][k2].numpy(), np.asarray(w2), err_msg=f"{key} {k2}")
        else:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(w), err_msg=key)


@pytest.mark.parametrize("iou_type", ["segm", ("bbox", "segm"), ("segm", "bbox")])
@pytest.mark.parametrize(("backend", "average"), [("native", "macro"), ("native_numpy", "macro"), ("native", "micro")])
def test_segm_map(iou_type, backend, average):
    kw = dict(iou_type=iou_type, backend=backend, average=average, class_metrics=True, extended_summary=True)
    jm, tm = jdet.MeanAveragePrecision(**kw), tdet.MeanAveragePrecision(device="cpu", **kw)
    for seed in (0, 1):
        _feed(jm, tm, *_mask_images(seed))
    got, want = tm.compute(), jm.compute()
    _assert_map_equal(got, want)
    prefix = "" if isinstance(iou_type, str) else "segm_"
    assert got[f"{prefix}precision"].shape == (10, 101, 1 if average == "micro" else 3, 4, 3)
    assert float(got[f"{prefix}map"]) > 0


def test_segm_map_plain_options():
    kw = dict(iou_type="segm", iou_thresholds=[0.2, 0.5, 1.0], max_detection_thresholds=[1, 2, 4])
    jm, tm = jdet.MeanAveragePrecision(**kw), tdet.MeanAveragePrecision(device="cpu", **kw)
    _feed(jm, tm, *_mask_images(5, n_img=5))
    _assert_map_equal(tm.compute(), jm.compute())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_iou_plain_is_jax_float64_product_bit_for_bit(seed):
    """Each image's IoUs from the exact counts equal ``_mask_iou_crowd``'s float64 product, bit for bit."""
    preds, targets = _mask_images(seed)
    counts = kmi.mask_iou_counts([torch.from_numpy(p["masks"]) for p in preds],
                                 [torch.from_numpy(t["masks"]) for t in targets])
    for (inter, da, ga), p, t in zip(counts, preds, targets):
        crowd = t["iscrowd"].astype(bool)
        want = _mask_iou_crowd(p["masks"], t["masks"], crowd)
        got = _mask_iou_from_counts(inter.numpy(), da.numpy(), ga.numpy(), crowd)
        assert got.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
        np.testing.assert_array_equal(da.numpy(), p["masks"].sum((1, 2)))
        np.testing.assert_array_equal(ga.numpy(), t["masks"].sum((1, 2)))


def _kernel_model(det_masks, gt_masks, min_blocks=0):
    """numpy model of ``csrc/mask_iou.cu`` on ``kernels.mask_iou.plan``'s entries: each block packs its chunk of
    the entry's masks into groups of 16 32-bit words of 512 pixels, bit ``lane`` of word k pixel 16 lane + k of
    the group (16 ballots of each lane's 16 bytes; zero bits past the mask's end), adds each mask's popcount to
    its area (the first ground-truth block's entries the detections', the first detection block's the ground
    truths') and each pair's ``popc(det & gt)`` sum to its count."""
    shapes = [(d.shape[0], g.shape[0], d.shape[1] * d.shape[2]) for d, g in zip(det_masks, gt_masks)]
    out = [(np.zeros((n_d, n_g), np.int64), np.zeros(n_d, np.int64), np.zeros(n_g, np.int64))
           for n_d, n_g, _ in shapes]
    weights = (1 << np.arange(32, dtype=np.uint64))
    pop = np.vectorize(lambda x: bin(int(x)).count("1"))
    for e in kmi.plan(shapes, min_blocks):
        n_d, n_g, hw = shapes[e.image]
        assert (e.words | 1) * (e.n_det + e.n_gt) <= kmi.SHARED_WORDS and e.n_det + e.n_gt <= kmi.MAX_MASKS
        assert e.words % kmi.GROUP == 0
        d = det_masks[e.image].reshape(n_d, -1)[e.d0:e.d0 + e.n_det]
        g = gt_masks[e.image].reshape(n_g, -1)[e.g0:e.g0 + e.n_gt]
        inter, det_area, gt_area = out[e.image]
        for chunk in range(e.chunks):
            px0 = chunk * e.words * 32
            pixels = np.zeros((e.n_det + e.n_gt, e.words * 32), bool)
            stop = min(px0 + e.words * 32, hw)
            pixels[:, :stop - px0] = np.concatenate([d, g])[:, px0:stop]
            # (mask, group, lane, k) -> word (group, k), bit lane
            lanes = pixels.reshape(len(pixels), e.words // kmi.GROUP, 32, kmi.GROUP).transpose(0, 1, 3, 2)
            words = (lanes.astype(np.uint64) * weights).sum(-1).reshape(len(pixels), e.words)
            if e.g0 == 0:
                det_area[e.d0:e.d0 + e.n_det] += pop(words[:e.n_det]).sum(1) if e.n_det else 0
            if e.d0 == 0:
                gt_area[e.g0:e.g0 + e.n_gt] += pop(words[e.n_det:]).sum(1)
            pairs = words[:e.n_det, None, :] & words[None, e.n_det:, :]
            inter[e.d0:e.d0 + e.n_det, e.g0:e.g0 + e.n_gt] += pop(pairs).sum(-1)
    return out


@pytest.mark.parametrize(("shapes", "hw", "min_blocks"), [
    ([(5, 3), (0, 2), (2, 0), (1, 1)], (17, 13), 0),  # H W = 221: a tail group, empty sides
    ([(200, 90)], (3, 11), 0),  # D + G > 256: blocks of detections and ground truths, a group each
    ([(7, 4)], (40, 64), 0),  # whole groups, one chunk
    ([(7, 4), (3, 2)], (48, 70), 12),  # chunks halved for a grid of 12 blocks: several chunks an image
])
def test_kernel_model_against_jax(shapes, hw, min_blocks):
    rng = np.random.default_rng(len(shapes))
    det = [rng.uniform(size=(n_d, *hw)) < 0.4 for n_d, _ in shapes]
    gt = [rng.uniform(size=(n_g, *hw)) < 0.5 for _, n_g in shapes]
    if shapes[0][0] > 1:
        det[0][1] = True  # all full
        det[0][0] = False  # all empty
    for (inter, da, ga), d, g in zip(_kernel_model(det, gt, min_blocks), det, gt):
        want = _mask_iou_crowd(d, g, np.zeros(g.shape[0], bool))
        if d.shape[0] and g.shape[0]:
            union = da[:, None] + ga[None, :] - inter
            np.testing.assert_array_equal(inter / np.maximum(union, 1e-12), want)
            np.testing.assert_array_equal(da, d.reshape(len(d), -1).sum(1))
            np.testing.assert_array_equal(ga, g.reshape(len(g), -1).sum(1))
        else:
            assert want.shape == inter.shape and not inter.any()


def test_mask_iou_plan_and_checks():
    assert kmi.chunk_words(107) == 96 and (96 | 1) * 107 <= kmi.SHARED_WORDS
    assert kmi.chunk_words(2) == kmi.MAX_WORDS and kmi.chunk_words(kmi.MAX_MASKS) == 32
    one = kmi.plan([(100, 7, 480 * 640)])
    assert one[0].words == 96 and one[0].chunks == 100
    cut = kmi.plan([(100, 7, 480 * 640)], min_blocks=264)  # two blocks an SM of 132: chunks of 32 words
    assert cut[0].words == 32 and cut[0].chunks == 300
    entries = kmi.plan([(100, 7, 480 * 640), (0, 3, 100), (300, 200, 187_500)])
    assert [e.image for e in entries].count(0) == 1 and all(e.image != 1 for e in entries)
    big = [e for e in entries if e.image == 2]
    assert len(big) == 3 * 2 and all(e.n_det + e.n_gt <= kmi.MAX_MASKS for e in big)
    assert entries[1].first_block == entries[0].chunks
    with pytest.raises(ValueError, match="bool"):
        kmi.mask_iou([torch.zeros((1, 2, 2), dtype=torch.uint8)], [torch.zeros((1, 2, 2), dtype=torch.bool)])
    with pytest.raises(ValueError, match="CUDA"):
        kmi.mask_iou([torch.zeros((1, 2, 2), dtype=torch.bool)], [torch.zeros((1, 2, 2), dtype=torch.bool)])
    with pytest.raises(ValueError, match="masks"):
        kmi.mask_iou_counts([torch.zeros((1, 2, 2), dtype=torch.bool)], [torch.zeros((1, 2, 3), dtype=torch.bool)])


# --------------------------------------------------------------------- COCO I/O
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rle_codec_byte_for_byte(seed):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(13 + seed, 29)) < (0.05, 0.5, 0.95, 0.0)[seed]
    mask[2:9, 4:20] = seed != 3
    want = jcoco.rle_encode(mask)
    got = tcoco.rle_encode(mask)
    assert got == want and isinstance(got["counts"], str)
    assert tcoco.rle_encode(mask, compress=False) == jcoco.rle_encode(mask, compress=False)
    np.testing.assert_array_equal(tcoco.rle_decode(got), mask.astype(np.uint8))
    counts = [int(c) for c in rng.integers(0, 2**20, 40)] + [0, 1, 31, 32, 1023, 1024]
    assert tcoco._counts_to_string(counts) == jcoco._counts_to_string(counts)
    assert tcoco._counts_from_string(jcoco._counts_to_string(counts)) == counts


def test_ann_to_mask_polygons_and_uncompressed_rle():
    polygon = {"segmentation": [[2.0, 3.0, 20.5, 4.0, 15.0, 17.25, 3.0, 12.0], [22.0, 2.0, 27.0, 2.0, 25.0, 9.0]]}
    np.testing.assert_array_equal(tcoco.ann_to_mask(polygon, 19, 30), jcoco.ann_to_mask(polygon, 19, 30))
    rle = {"segmentation": {"size": [6, 5], "counts": [3, 4, 10, 2, 11]}}
    np.testing.assert_array_equal(tcoco.ann_to_mask(rle, 6, 5), jcoco.ann_to_mask(rle, 6, 5))
    with pytest.raises(ValueError, match="Unsupported"):
        tcoco.ann_to_mask({"segmentation": 3}, 2, 2)


def test_tm_to_coco_and_back(tmp_path):
    preds, targets = _mask_images(7, n_img=4)
    kw = dict(iou_type=("bbox", "segm"))
    jm, tm = jdet.MeanAveragePrecision(**kw), tdet.MeanAveragePrecision(device="cpu", **kw)
    _feed(jm, tm, preds, targets)
    tm.tm_to_coco(str(tmp_path / "port"))
    jm.tm_to_coco(str(tmp_path / "jax"))
    for side in ("preds", "target"):
        got = json.loads((tmp_path / f"port_{side}.json").read_text())
        want = json.loads((tmp_path / f"jax_{side}.json").read_text())
        assert got == want, side
    p2, t2 = tdet.MeanAveragePrecision.coco_to_tm(str(tmp_path / "port_preds.json"), str(tmp_path / "port_target.json"),
                                                  iou_type=["bbox", "segm"], device="cpu")
    jp2, jt2 = jdet.MeanAveragePrecision.coco_to_tm(str(tmp_path / "jax_preds.json"), str(tmp_path / "jax_target.json"),
                                                    iou_type=["bbox", "segm"])
    for got, want in ((p2, jp2), (t2, jt2)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
    for g, p in zip(t2, targets):  # the round trip keeps the masks, and the boxes in xywh
        np.testing.assert_array_equal(g["masks"].numpy().astype(bool), p["masks"])
    again = tdet.MeanAveragePrecision(device="cpu", box_format="xywh", **kw)
    again.update(p2, t2)
    assert float(again.compute()["segm_map"]) > 0


# ------------------------------------------------------------ panoptic quality
THINGS, STUFFS = {0, 1, 3}, {6, 7}


def _panoptic(seed, b=3, hw=(14, 17), unknown=False):
    rng = np.random.default_rng(seed)
    cats = np.asarray(sorted(THINGS | STUFFS) + ([9] if unknown else []))

    def one():
        x = np.zeros((b, *hw, 2), np.int64)
        x[..., 0] = cats[rng.integers(0, len(cats), (b, hw[0] // 4 + 1, hw[1] // 4 + 1))].repeat(4, 1).repeat(4, 2)[
            :, :hw[0], :hw[1]]
        x[..., 1] = rng.integers(0, 3, (b, *hw))
        return x

    target = one()
    preds = target.copy()
    flip = rng.uniform(size=(b, *hw)) < 0.3
    preds[flip] = one()[flip]
    preds[0, :5, :5, 1] = 16_000_000  # COCO-panoptic's RGB-encoded instance ids
    target[0, :5, :5, 1] = 16_000_001
    target[1, :3] = [8, 0]  # an unknown target category: void
    target[-1] = [9 if unknown else 8, 0]  # an all-void image
    return preds, target


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("modified", [False, True])
def test_panoptic_counts_per_image(seed, modified):
    preds, target = _panoptic(seed)
    void = jpq._get_void_color(THINGS, STUFFS)
    cats = {c: i for i, c in enumerate([*sorted(THINGS), *sorted(STUFFS)])}
    jp = jpq._preprocess_inputs(THINGS, STUFFS, preds, void, False)
    jt = jpq._preprocess_inputs(THINGS, STUFFS, target, void, True)
    tp_ = tpq._preprocess_inputs(THINGS, STUFFS, torch.from_numpy(preds), void, False)
    tt_ = tpq._preprocess_inputs(THINGS, STUFFS, torch.from_numpy(target), void, True)
    np.testing.assert_array_equal(tp_.numpy(), jp)
    np.testing.assert_array_equal(tt_.numpy(), jt)
    mod = STUFFS if modified else None
    for b in range(preds.shape[0]):
        want = jpq._panoptic_quality_update_sample(jp[b], jt[b], cats, void, mod)
        got = tpq._panoptic_quality_update_sample(tp_[b], tt_[b], cats, void, mod)
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-12, atol=0)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), w)
    assert int(sum(w.sum() for w in want[1:])) == 0  # the all-void image counts nothing


@pytest.mark.parametrize(("sq_rq", "per_class"), [(False, False), (True, False), (False, True), (True, True)])
def test_panoptic_functionals(sq_rq, per_class):
    preds, target = _panoptic(4, unknown=True)
    kw = dict(things=THINGS, stuffs=STUFFS, allow_unknown_preds_category=True)
    want = jpq.panoptic_quality(jnp.asarray(preds), jnp.asarray(target), return_sq_and_rq=sq_rq,
                                return_per_class=per_class, **kw)
    got = tpq.panoptic_quality(torch.from_numpy(preds), torch.from_numpy(target), return_sq_and_rq=sq_rq,
                               return_per_class=per_class, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    want = jpq.modified_panoptic_quality(jnp.asarray(preds), jnp.asarray(target), **kw)
    got = tpq.modified_panoptic_quality(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="Unknown categories"):
        tpq.panoptic_quality(torch.from_numpy(preds), torch.from_numpy(target), THINGS, STUFFS)


@pytest.mark.parametrize("name", ["PanopticQuality", "ModifiedPanopticQuality"])
def test_panoptic_classes(name):
    kw = dict(things=THINGS, stuffs=STUFFS)
    extra = {} if name == "ModifiedPanopticQuality" else dict(return_sq_and_rq=True, return_per_class=True)
    jm, tm = getattr(jdet, name)(**kw, **extra), getattr(tdet, name)(device="cpu", **kw, **extra)
    for seed in (5, 6):
        preds, target = _panoptic(seed)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    for key, w in jm.metric_state.items():
        g = tm.metric_state[key]
        assert g.dtype == torch.float32 if key != "_n" else g.dtype == torch.int32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, err_msg=key)
    np.testing.assert_allclose(tm.compute().numpy(), np.asarray(jm.compute()), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="shape"):
        tm.update(torch.zeros((1, 4, 2), dtype=torch.int64), torch.zeros((1, 4, 3), dtype=torch.int64))


def _out_of_map_case(side):
    """A thing 0 of instance 1 beside a stuff 6, ``(1, 2, 2, 2)``; ``side`` gets the thing's instance -1,
    which moves its segment to category -1, outside the map of things {0, 1} and stuffs {6}."""
    target = np.zeros((1, 2, 2, 2), np.int64)
    target[0, :, 0] = [0, 1]
    target[0, :, 1] = [6, 0]
    preds = target.copy()
    {"preds": preds, "target": target, "both": preds}[side][0, :, 0, 1] = -1
    if side == "both":
        target[0, :, 0, 1] = -1
    return preds, target


def _pq_outcome(pkg, fn, preds, target, **kw):
    """The result as numpy, or the ``KeyError``'s argument."""
    try:
        return np.asarray(getattr(pkg, fn)(preds, target, **kw), np.float64)
    except KeyError as err:
        return ("KeyError", err.args)


@pytest.mark.parametrize("side", ["preds", "target", "both"])
@pytest.mark.parametrize("fn", ["panoptic_quality", "modified_panoptic_quality"])
def test_panoptic_out_of_map_category_raises_as_in_jax(side, fn):
    preds, target = _out_of_map_case(side)
    kw = dict(things={0, 1}, stuffs={6}, **({"return_per_class": True} if fn == "panoptic_quality" else {}))
    want = _pq_outcome(jpq, fn, jnp.asarray(preds), jnp.asarray(target), **kw)
    assert want == ("KeyError", (-1,))
    with pytest.raises(KeyError) as err:
        getattr(tpq, fn)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    assert err.value.args == (-1,)


@pytest.mark.parametrize("side", ["preds", "target", "both"])
@pytest.mark.parametrize("name", ["PanopticQuality", "ModifiedPanopticQuality"])
def test_panoptic_classes_out_of_map_category_raises_as_in_jax(side, name):
    preds, target = _out_of_map_case(side)
    jm, tm = getattr(jdet, name)(things={0, 1}, stuffs={6}), getattr(tdet, name)(things={0, 1}, stuffs={6}, device="cpu")
    with pytest.raises(KeyError, match="-1"):
        jm.update(jnp.asarray(preds), jnp.asarray(target))
    with pytest.raises(KeyError, match="-1"):
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))


@pytest.mark.parametrize("side", ["preds", "target"])
@pytest.mark.parametrize("fn", ["panoptic_quality", "modified_panoptic_quality"])
def test_panoptic_out_of_map_segment_mostly_void_is_never_looked_up(side, fn):
    """A segment outside the map that lies more than half on void is neither a match, a false negative nor a
    false positive: the JAX package never looks it up, and neither package raises."""
    segment = np.zeros((1, 2, 3, 2), np.int64)
    segment[0, 0] = [0, -1]  # category -1 over the top row
    segment[0, 1] = [6, 0]
    void = segment.copy()
    void[0, 0, :2] = [9, 0]  # unknown: void under two thirds of the segment
    void[0, 0, 2] = [1, 1]
    preds, target = (segment, void) if side == "preds" else (void, segment)
    kw = dict(things={0, 1}, stuffs={6}, allow_unknown_preds_category=True)
    want = _pq_outcome(jpq, fn, jnp.asarray(preds), jnp.asarray(target), **kw)
    got = _pq_outcome(tpq, fn, torch.from_numpy(preds), torch.from_numpy(target), **kw)
    assert isinstance(want, np.ndarray) and isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("modified", [False, True])
def test_panoptic_negative_instances_against_jax(seed, modified):
    """Negative instance ids scattered over both sides: both packages raise, or neither, with equal counts."""
    preds, target = _panoptic(seed, b=3, hw=(9, 10))
    rng = np.random.default_rng(100 + seed)
    for x in (preds, target):
        x[..., 1] = np.where(rng.uniform(size=x.shape[:-1]) < 0.03, -1, x[..., 1])
    void = jpq._get_void_color(THINGS, STUFFS)
    cats = {c: i for i, c in enumerate([*sorted(THINGS), *sorted(STUFFS)])}
    mod = STUFFS if modified else None
    jp = jpq._preprocess_inputs(THINGS, STUFFS, preds, void, False)
    jt = jpq._preprocess_inputs(THINGS, STUFFS, target, void, True)
    for b in range(preds.shape[0]):
        try:
            want = jpq._panoptic_quality_update_sample(jp[b], jt[b], cats, void, mod)
        except KeyError:
            want = None
        args = (torch.from_numpy(jp[b]), torch.from_numpy(jt[b]), cats, void, mod)
        if want is None:
            with pytest.raises(KeyError):
                tpq._panoptic_quality_update_sample(*args)
            continue
        got = tpq._panoptic_quality_update_sample(*args)
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-12, atol=0)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy(), w)
