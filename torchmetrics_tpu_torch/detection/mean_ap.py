"""Mean Average Precision, the native COCO evaluator (counterpart of ``torchmetrics_tpu/detection/mean_ap.py``).

The COCOeval protocol: greedy per-class matching at 10 IoU thresholds,
crowd handling, 4 area ranges, maxDets caps, 101-point interpolated
precision. States are per-image variable-length tensors kept as list
states, synced by the ragged pad-gather-trim
(:func:`torchmetrics_tpu_torch.parallel.sync_ragged_states`).

``compute`` runs on the host, in numpy, except the matcher: with
``backend="native"`` every (class, image) item is matched by
:func:`~torchmetrics_tpu_torch.functional.detection.matcher.match_batch_padded`
on the metric's device (the ``coco_match`` CUDA kernel on the card);
``backend="native_numpy"`` runs ``_evaluate_image``, the per-image host
loop kept as the oracle. The JAX package loops over (class, area range,
maxDets, image); the port concatenates each class's images once and
selects each maxDets cap by a detection's rank in its image, which gives
the same arrays in the same order.

``iou_type="segm"`` keeps bool mask states ``(N, H, W)`` as the JAX
package does; its IoUs come from the exact intersection counts and areas of
one ``mask_iou`` launch over every image the compute evaluates
(:func:`~torchmetrics_tpu_torch.kernels.mask_iou.mask_iou_counts`), taken in
float64 as ``inter / max(union, 1e-12)``, the same values as the JAX
package's float64 product bit for bit. With both types every result key but
``classes`` takes a ``bbox_`` or ``segm_`` prefix, and the ground-truth area
that both passes keep is derived from the masks. ``extended_summary`` adds
``precision``, ``recall``, ``scores`` and the ``ious`` of every (image,
class). ``coco_to_tm`` and ``tm_to_coco`` read and write COCO files
(:mod:`torchmetrics_tpu_torch.detection.coco_io`).

``approx="sketch"`` swaps the per-image list states for fixed-shape score
histograms per (class, IoU threshold)
(:class:`~torchmetrics_tpu_torch.sketches.QuantileSketch`, over the class ids
``[0, sketch_classes)``): each (class, image) item is matched at update time
(area range "all", the largest maxDets cap), on the metric's device by
:func:`~torchmetrics_tpu_torch.functional.detection.matcher.match_batch` with
``backend="native"`` and on the host by ``_evaluate_image`` with
``backend="native_numpy"``, and only the true- and false-positive score
histograms, the true-positive counts
at each cap and the valid ground truths and detections a class accumulate,
all ``sum``-merged (the planner's sum buckets, no gather). Every histogram
cell boundary is an exact operating point of the exact PR curve, so the
sketch's interpolated AP can only fall below the exact one, by at most the
data-dependent bound that :meth:`MeanAveragePrecision._gather_approx_provenance`
reports after a compute. The area-banded keys are -1. As in the JAX package,
``approx="sketch"`` refuses ``iou_type="segm"`` and ``extended_summary``.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.detection import MeanAveragePrecision
    >>> preds = [dict(boxes=torch.tensor([[258.0, 41.0, 606.0, 285.0]]),
    ...               scores=torch.tensor([0.536]), labels=torch.tensor([0]))]
    >>> target = [dict(boxes=torch.tensor([[214.0, 41.0, 562.0, 285.0]]), labels=torch.tensor([0]))]
    >>> metric = MeanAveragePrecision(device="cpu")
    >>> metric.update(preds, target)
    >>> round(float(metric.compute()['map']), 4)
    0.6
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.detection.box_ops import box_convert
from torchmetrics_tpu_torch.functional.detection.matcher import _CHUNK, _bucket, match_batch, match_batch_padded
from torchmetrics_tpu_torch.kernels.mask_iou import mask_iou_counts
from torchmetrics_tpu_torch.sketches.quantile import QuantileSketch
from torchmetrics_tpu_torch.utilities.data import resolve_device

_AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}

_STATE_NAMES = ("detection_scores", "detection_labels", "groundtruth_labels", "groundtruth_crowds",
                "groundtruth_area")
_ITEM_STATES = {"bbox": ("detection_boxes", "groundtruth_boxes"), "segm": ("detection_masks", "groundtruth_masks")}


def _box_iou_crowd(det: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU with COCO crowd semantics: for a crowd gt the union is
    the detection's area (pycocotools ``maskUtils.iou``)."""
    if det.size == 0 or gt.size == 0:
        return np.zeros((det.shape[0], gt.shape[0]))
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    det_area = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    gt_area = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = det_area[:, None] + gt_area[None, :] - inter
    union = np.where(iscrowd[None, :].astype(bool), det_area[:, None], union)
    return inter / np.maximum(union, 1e-12)


def _box_iou_crowd_padded(det: Tensor, gt: Tensor, crowd: Tensor) -> Tensor:
    """:func:`_box_iou_crowd` of padded items in torch: ``(B, D, G)`` float32 from ``(B, D, 4)`` and ``(B, G, 4)``
    float32 boxes and ``(B, G)`` crowd flags, the same operations in the same order, so the same values."""
    lt = torch.maximum(det[:, :, None, :2], gt[:, None, :, :2])
    rb = torch.minimum(det[:, :, None, 2:], gt[:, None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    det_area = (det[..., 2] - det[..., 0]) * (det[..., 3] - det[..., 1])
    gt_area = (gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1])
    union = det_area[:, :, None] + gt_area[:, None, :] - inter
    union = torch.where(crowd[:, None, :], det_area[:, :, None], union)
    return (inter / torch.clamp_min(union, 1e-12)).contiguous()


def _mask_iou_from_counts(inter: np.ndarray, det_area: np.ndarray, gt_area: np.ndarray,
                          iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise mask IoU from exact integer counts, crowd semantics as above, in float64: the JAX package's
    float64 product ``d @ g.T`` and row sums give these integers, so the values are its own bit for bit."""
    if inter.size == 0:
        return np.zeros(inter.shape)
    d_area = det_area.astype(np.float64)
    union = d_area[:, None] + gt_area.astype(np.float64)[None, :] - inter.astype(np.float64)
    union = np.where(iscrowd[None, :].astype(bool), d_area[:, None], union)
    return inter.astype(np.float64) / np.maximum(union, 1e-12)


def _evaluate_image(
    ious: np.ndarray,
    det_scores: np.ndarray,
    gt_crowd: np.ndarray,
    gt_area: np.ndarray,
    det_area: np.ndarray,
    iou_thrs: np.ndarray,
    area_rng: Tuple[float, float],
    max_det: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """COCOeval.evaluateImg for one (class, image): the greedy match per IoU threshold.

    Returns ``(dt_matches (T, D'), dt_ignore (T, D'), scores (D',), n_valid_gt)``.
    """
    gt_ignore = gt_crowd | (gt_area < area_rng[0]) | (gt_area > area_rng[1])
    g_order = np.argsort(gt_ignore, kind="stable")  # non-ignored gts first
    gt_ignore_sorted = gt_ignore[g_order]
    d_order = np.argsort(-det_scores, kind="stable")[:max_det]
    n_d, n_g, n_t = len(d_order), len(g_order), len(iou_thrs)
    dtm = np.zeros((n_t, n_d), dtype=np.int64) - 1
    dt_ig = np.zeros((n_t, n_d), dtype=bool)
    gtm = np.zeros((n_t, n_g), dtype=np.int64) - 1
    ious_s = ious[np.ix_(d_order, g_order)] if n_d and n_g else np.zeros((n_d, n_g))
    # compare in float32, the matcher's type, so that the two backends break a
    # tie at an IoU exactly on a threshold alike
    ious_s = ious_s.astype(np.float32)
    crowd_sorted = gt_crowd[g_order]
    for ti, t in enumerate(iou_thrs):
        for di in range(n_d):
            best_iou = np.float32(min(t, 1 - 1e-10))
            m = -1
            for gi in range(n_g):
                if gtm[ti, gi] >= 0 and not crowd_sorted[gi]:
                    continue
                if m > -1 and not gt_ignore_sorted[m] and gt_ignore_sorted[gi]:
                    break  # only ignored gts remain; keep the non-ignored match
                if ious_s[di, gi] < best_iou:
                    continue
                best_iou = ious_s[di, gi]
                m = gi
            if m != -1:
                dtm[ti, di] = m
                dt_ig[ti, di] = gt_ignore_sorted[m]
                gtm[ti, m] = di
    d_area_sorted = det_area[d_order]
    out_of_range = (d_area_sorted < area_rng[0]) | (d_area_sorted > area_rng[1])
    dt_ig = dt_ig | ((dtm == -1) & out_of_range[None, :])  # unmatched dets outside the range are ignored
    return (dtm >= 0), dt_ig, det_scores[d_order], int((~gt_ignore).sum())


def _matcher_items(items: List[Dict[str, np.ndarray]]) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The matcher's input of each (class, image) item: ``(ious (D, G))`` in
    score order, ``crowd (G,)`` and the ground truths ignored in each area
    range ``(A, G)``."""
    area_bounds = np.asarray(list(_AREA_RANGES.values()))  # (A, 2)
    out = []
    for it in items:
        gt_ignore = it["crowd"][None, :] | (it["gt_area"][None, :] < area_bounds[:, :1]) | (
            it["gt_area"][None, :] > area_bounds[:, 1:]
        )
        out.append((it["ious"][it["order"]], it["crowd"], gt_ignore))
    return out


def _accumulate(tp: np.ndarray, ig: np.ndarray, scores: np.ndarray, npig: int, rec_thrs: np.ndarray):
    """pycocotools ``accumulate`` for one (class, area, maxDets) cell:
    ``(recall (T,), precision (T, R), scores (T, R))`` from the score-ordered
    matches, ``scores`` the score at each recall point (``extended_summary``)."""
    order = np.argsort(-scores, kind="mergesort")
    tp, ig, scores = tp[:, order], ig[:, order], scores[order]
    tp_cum = np.cumsum(tp & ~ig, axis=1).astype(np.float64)
    fp_cum = np.cumsum(~tp & ~ig, axis=1).astype(np.float64)
    n_t, nd = tp_cum.shape
    rc = tp_cum / npig
    pr = tp_cum / np.maximum(fp_cum + tp_cum, np.spacing(1))
    if not nd:
        return np.zeros(n_t), np.zeros((n_t, len(rec_thrs))), np.zeros((n_t, len(rec_thrs)))
    # monotone precision envelope from the right: a reversed running max
    pr_env = np.flip(np.maximum.accumulate(np.flip(pr, axis=1), axis=1), axis=1)
    inds = np.stack([np.searchsorted(rc[ti], rec_thrs, side="left") for ti in range(n_t)])
    hit = inds < nd
    safe = np.minimum(inds, nd - 1)
    return rc[:, -1], np.where(hit, np.take_along_axis(pr_env, safe, axis=1), 0.0), np.where(hit, scores[safe], 0.0)


class MeanAveragePrecision(Metric):
    """COCO mAP/mAR of box or mask detections."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = True

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_type: Union[str, Tuple[str, ...]] = "bbox",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        extended_summary: bool = False,
        average: str = "macro",
        backend: str = "native",
        sketch_classes: int = 91,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if box_format not in ("xyxy", "xywh", "cxcywh"):
            raise ValueError(f"Expected argument `box_format` to be one of ('xyxy', 'xywh', 'cxcywh') but got {box_format}")
        iou_types = (iou_type,) if isinstance(iou_type, str) else tuple(iou_type)
        for it in iou_types:
            if it not in ("bbox", "segm"):
                raise ValueError(f"Expected argument `iou_type` to be one of ('bbox', 'segm') but got {it}")
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        if average not in ("macro", "micro"):
            raise ValueError(f"Expected argument `average` to be one of ('macro', 'micro') but got {average}")
        if backend not in ("native", "native_numpy"):
            raise ValueError(f"Expected argument `backend` to be one of ('native', 'native_numpy') but got {backend}")
        self.box_format = box_format
        self.iou_types = iou_types
        self.iou_type = iou_types[0]
        self.iou_thresholds = np.asarray(
            iou_thresholds if iou_thresholds is not None else np.round(np.arange(0.5, 1.0, 0.05), 2)
        )
        self.rec_thresholds = np.asarray(
            rec_thresholds if rec_thresholds is not None else np.round(np.arange(0.0, 1.01, 0.01), 2)
        )
        mdt = max_detection_thresholds if max_detection_thresholds is not None else [1, 10, 100]
        if len(mdt) != 3:
            raise ValueError("Argument `max_detection_thresholds` must be a list of length 3")
        self.max_detection_thresholds = sorted(mdt)
        self.class_metrics = class_metrics
        self.extended_summary = extended_summary
        self.average = average
        self.backend = backend
        if not (isinstance(sketch_classes, int) and sketch_classes >= 1):
            raise ValueError(f"Argument `sketch_classes` must be a positive int, got {sketch_classes!r}")
        #: the class ids of the sketch-mode histograms, ``[0, sketch_classes)``; 91 covers the COCO category ids
        self.sketch_classes = sketch_classes
        self._install_approx_states()

    def _install_approx_states(self) -> None:
        """Register the state leaves of the current ``approx`` config (the :meth:`set_approx` hook)."""
        if self.approx == "sketch":
            if "segm" in self.iou_types:
                raise ValueError(
                    "MeanAveragePrecision(approx='sketch') supports iou_type='bbox' only: "
                    "mask states cannot be histogram-summarized"
                )
            if self.extended_summary:
                raise ValueError(
                    "MeanAveragePrecision(approx='sketch') does not keep the raw "
                    "per-detection arrays `extended_summary` reports; use the exact path"
                )
            self._map_sketch = QuantileSketch.for_error(self.approx_error)
            k, t, m = self.sketch_classes, len(self.iou_thresholds), len(self.max_detection_thresholds)
            spec = self._map_sketch.reduce_spec
            self.add_state("score_hist_tp", self._map_sketch.init((k, t)), dist_reduce_fx=spec)
            self.add_state("score_hist_fp", self._map_sketch.init((k, t)), dist_reduce_fx=spec)
            self.add_state("tp_count", torch.zeros((m, k, t)), dist_reduce_fx="sum")
            self.add_state("gt_total", torch.zeros((k,)), dist_reduce_fx="sum")
            self.add_state("det_total", torch.zeros((k,)), dist_reduce_fx="sum")
            return
        self._map_sketch = None
        # box and mask item states coexist when iou_types has both
        for name in _STATE_NAMES + sum((_ITEM_STATES[t] for t in ("bbox", "segm") if t in self.iou_types), ()):
            self.add_state(name, [], dist_reduce_fx=None)

    # -------------------------------------------------------------- update
    def _update(self, state: State, preds: List[Dict[str, Tensor]], target: List[Dict[str, Tensor]]) -> State:
        if not isinstance(preds, Sequence) or not isinstance(target, Sequence):
            raise ValueError("Expected argument `preds` and `target` to be a sequence of dicts")
        if len(preds) != len(target):
            raise ValueError("Expected argument `preds` and `target` to have the same length")
        item_keys = ["masks" if it == "segm" else "boxes" for it in self.iou_types]
        for p in preds:
            for k in item_keys + ["scores", "labels"]:
                if k not in p:
                    raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")
        for t in target:
            for k in item_keys + ["labels"]:
                if k not in t:
                    raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")
        if self._map_sketch is not None:
            return self._update_sketch(state, preds, target)
        new = dict(state)

        def add(name: str, value: Tensor) -> None:
            new[name] = new[name] + (value,)

        for p, t in zip(preds, target):
            gt_labels = self._tensor(t["labels"]).reshape(-1)
            n_gt = gt_labels.shape[0]
            crowds = t.get("iscrowd")
            crowds = torch.zeros(n_gt, dtype=torch.int32) if crowds is None else crowds
            area = t.get("area")
            if area is not None and self._tensor(area).numel() == n_gt:
                area = self._tensor(area).to(torch.float32).reshape(-1)
            else:  # sentinel: the area is derived from the box or mask at compute
                area = torch.full((n_gt,), -1.0, dtype=torch.float32, device=self.device)
            if "bbox" in self.iou_types:
                add("detection_boxes", self._convert_boxes(p["boxes"]))
                add("groundtruth_boxes", self._convert_boxes(t["boxes"]))
            if "segm" in self.iou_types:
                add("detection_masks", self._tensor(p["masks"]).to(torch.bool))
                add("groundtruth_masks", self._tensor(t["masks"]).to(torch.bool))
            add("detection_scores", self._tensor(p["scores"]).to(torch.float32).reshape(-1))
            add("detection_labels", self._tensor(p["labels"]).reshape(-1))
            add("groundtruth_labels", gt_labels)
            add("groundtruth_crowds", self._tensor(crowds).reshape(-1))
            add("groundtruth_area", area)
        return new

    def _convert_boxes(self, boxes: Any) -> Tensor:
        boxes = self._tensor(boxes).to(torch.float32)
        boxes = boxes.reshape(-1, 4) if boxes.numel() else torch.zeros((0, 4), device=self.device)
        return box_convert(boxes, in_fmt=self.box_format, out_fmt="xyxy")

    # ------------------------------------------------------------ sketch mode
    def _update_sketch(self, state: State, preds: List[Dict[str, Tensor]], target: List[Dict[str, Tensor]]) -> State:
        """Match each (class, image) item of the update now (area range "all", the largest maxDets cap) and fold
        only the true- and false-positive score histograms and the exact counters in (float32, as the JAX package).

        With ``backend="native"`` the whole update runs on the metric's device: the items are padded together,
        their IoUs computed, matched by one :func:`match_batch` call a chunk of ``_CHUNK`` items (the
        ``coco_match`` kernel on the card) and folded by ``index_add``; one host read an update sizes the padding.
        ``backend="native_numpy"`` matches image by image on the host with ``_evaluate_image``, the oracle.
        """
        if self.backend == "native_numpy":
            return self._update_sketch_numpy(state, preds, target)
        if not preds:
            return dict(state)
        sketch, n_k, n_t = self._map_sketch, self.sketch_classes, len(self.iou_thresholds)
        max_dets, dev = self.max_detection_thresholds, self.device
        det_boxes, det_scores, det_labels, det_img, gt_boxes, gt_labels, gt_crowd, gt_area, gt_img = (
            self._sketch_batch(preds, target))
        det_key, gt_key = det_img * n_k + det_labels, gt_img * n_k + gt_labels
        keys, inverse = torch.unique(torch.cat([det_key, gt_key]), return_inverse=True)
        n_items, n_det = keys.shape[0], det_key.shape[0]
        if n_items == 0:
            return dict(state)
        det_item, gt_item = inverse[:n_det], inverse[n_det:]
        det_count = torch.bincount(det_item, minlength=n_items)
        gt_count = torch.bincount(gt_item, minlength=n_items)
        # the one host read: each label's range (checked against the class space) and the padding's sizes
        labels = [(x, what) for x, what in ((det_labels, "preds"), (gt_labels, "target")) if x.numel()]
        head = torch.stack([v for x, _ in labels for v in (x.min(), x.max())] + [det_count.max(), gt_count.max()])
        *ranges, most_dets, most_gts = head.tolist()
        for (_, what), low, high in zip(labels, ranges[::2], ranges[1::2]):
            if low < 0 or high >= n_k:
                raise ValueError(
                    f"approx='sketch' holds per-class histograms over a fixed class "
                    f"space [0, {n_k}); got a `{what}` label {low if low < 0 else high}. "
                    "Raise `sketch_classes` to cover the label space."
                )
        n_d, n_g = _bucket(min(most_dets, max_dets[-1])), _bucket(most_gts)
        # each item's detections in score order (stable, as ``_evaluate_image`` takes them), cut to the cap; the
        # ones past it go to a spare column that is dropped
        order = torch.sort(-det_scores, stable=True).indices
        order = order[torch.sort(det_item[order], stable=True).indices]
        d_item = det_item[order]
        d_rank = torch.arange(n_det, device=dev) - (torch.cumsum(det_count, 0) - det_count)[d_item]
        d_rank = torch.where(d_rank < max_dets[-1], d_rank, n_d)
        g_order = torch.sort(gt_item, stable=True).indices
        g_item = gt_item[g_order]
        g_rank = torch.arange(g_item.shape[0], device=dev) - (torch.cumsum(gt_count, 0) - gt_count)[g_item]

        def pad(n: int, item: Tensor, rank: Tensor, value: Tensor) -> Tensor:
            out = torch.zeros((n_items, n + 1, *value.shape[1:]), dtype=value.dtype, device=dev)
            out[item, rank] = value
            return out[:, :n].contiguous()

        boxes_d = pad(n_d, d_item, d_rank, det_boxes[order])
        scores_d = pad(n_d, d_item, d_rank, det_scores[order])
        valid_d = pad(n_d, d_item, d_rank, torch.ones_like(d_item, dtype=torch.bool))
        boxes_g = pad(n_g, g_item, g_rank, gt_boxes[g_order])
        crowd_g = pad(n_g, g_item, g_rank, gt_crowd[g_order])
        valid_g = pad(n_g, g_item, g_rank, torch.ones_like(g_item, dtype=torch.bool))
        lo, hi = _AREA_RANGES["all"]
        area_g = pad(n_g, g_item, g_rank, gt_area[g_order])
        ignored_g = (crowd_g | (area_g < lo) | (area_g > hi)) & valid_g
        area_d = (boxes_d[..., 2] - boxes_d[..., 0]) * (boxes_d[..., 3] - boxes_d[..., 1])
        out_of_range = (area_d < lo) | (area_d > hi)
        cls = keys % n_k
        thrs = torch.as_tensor(np.asarray(self.iou_thresholds, np.float32), device=dev)
        h_tp, h_fp = (state[name].reshape(-1) for name in ("score_hist_tp", "score_hist_fp"))
        tp_count = state["tp_count"]
        n_cells = sketch.bins + 1
        for a in range(0, n_items, _CHUNK):
            b = slice(a, a + _CHUNK)
            ious = _box_iou_crowd_padded(boxes_d[b], boxes_g[b], crowd_g[b])
            matched, det_ignored = match_batch(ious, crowd_g[b], ignored_g[b, None], valid_d[b], valid_g[b], thrs)
            matched, det_ignored = matched[:, 0], det_ignored[:, 0]  # (B, T, D)
            ig = det_ignored | (~matched & out_of_range[b, None])
            tp = matched & ~ig & valid_d[b, None]
            fp = ~matched & ~ig & valid_d[b, None]
            cell = ((cls[b, None, None] * n_t + torch.arange(n_t, device=dev)[:, None]) * n_cells
                    + sketch.cell_index(scores_d[b])[:, None]).reshape(-1)
            h_tp = h_tp.index_add(0, cell, tp.reshape(-1).to(h_tp.dtype))
            h_fp = h_fp.index_add(0, cell, fp.reshape(-1).to(h_fp.dtype))
            caps = torch.stack([tp[..., :mdet].sum(-1) for mdet in max_dets], 0)  # (M, B, T)
            tp_count = tp_count.index_add(1, cls[b], caps.to(tp_count.dtype))
        counted = (valid_g & ~ignored_g).sum(-1).to(state["gt_total"].dtype)
        return {
            "score_hist_tp": h_tp.reshape(state["score_hist_tp"].shape),
            "score_hist_fp": h_fp.reshape(state["score_hist_fp"].shape),
            "tp_count": tp_count,
            "gt_total": state["gt_total"].index_add(0, cls, counted),
            "det_total": state["det_total"].index_add(0, cls, valid_d.sum(-1).to(state["det_total"].dtype)),
        }

    def _sketch_batch(self, preds: List[Dict[str, Tensor]], target: List[Dict[str, Tensor]]) -> Tuple[Tensor, ...]:
        """The update's detections and ground truths concatenated on the metric's device: ``(det_boxes xyxy,
        det_scores, det_labels, det_image, gt_boxes, gt_labels, gt_crowd, gt_area, gt_image)``, labels and images
        int64, the labels zero under ``average="micro"``; a ground truth's area is its positive user area, else its
        box's."""
        dev = self.device

        def flat(x: Any, dtype: torch.dtype) -> Tensor:
            return self._tensor(x).to(dtype).reshape(-1)

        det_boxes = self._convert_boxes(torch.cat([flat(p["boxes"], torch.float32) for p in preds]))
        gt_boxes = self._convert_boxes(torch.cat([flat(t["boxes"], torch.float32) for t in target]))
        det_scores = torch.cat([flat(p["scores"], torch.float32) for p in preds])
        det_labels = [flat(p["labels"], torch.int64) for p in preds]
        gt_labels = [flat(t["labels"], torch.int64) for t in target]
        crowd, user = [], []
        for t, labels in zip(target, gt_labels):
            n_gt = labels.shape[0]
            crowd.append(torch.zeros(n_gt, dtype=torch.bool, device=dev) if t.get("iscrowd") is None
                         else flat(t["iscrowd"], torch.bool))
            area = None if t.get("area") is None else flat(t["area"], torch.float32)
            user.append(area if area is not None and area.numel() == n_gt else torch.full((n_gt,), -1.0, device=dev))

        def image_of(per_image: List[Tensor]) -> Tensor:
            sizes = torch.tensor([x.shape[0] for x in per_image], device=dev)
            return torch.repeat_interleave(torch.arange(len(per_image), device=dev), sizes)

        det_img, gt_img = image_of(det_labels), image_of(gt_labels)
        det_labels, gt_labels, user = torch.cat(det_labels), torch.cat(gt_labels), torch.cat(user)
        if self.average == "micro":
            det_labels, gt_labels = torch.zeros_like(det_labels), torch.zeros_like(gt_labels)
        derived = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
        return (det_boxes, det_scores, det_labels, det_img, gt_boxes, gt_labels, torch.cat(crowd),
                torch.where(user > 0, user, derived), gt_img)

    def _update_sketch_numpy(self, state: State, preds: List[Dict[str, Tensor]],
                             target: List[Dict[str, Tensor]]) -> State:
        """The same fold matched image by image on the host by ``_evaluate_image``, as the JAX package does."""
        sketch, n_k, n_t = self._map_sketch, self.sketch_classes, len(self.iou_thresholds)
        max_dets = self.max_detection_thresholds
        h_tp, h_fp, tp_count, gt_total, det_total = (
            state[name].cpu().numpy().astype(np.float32)
            for name in ("score_hist_tp", "score_hist_fp", "tp_count", "gt_total", "det_total"))
        arng = _AREA_RANGES["all"]

        def host(x: Any, dtype) -> np.ndarray:
            return (x.cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)).astype(dtype).reshape(-1)

        for p, t in zip(preds, target):
            det_boxes = self._convert_boxes(p["boxes"]).cpu().numpy().reshape(-1, 4)
            gt_boxes = self._convert_boxes(t["boxes"]).cpu().numpy().reshape(-1, 4)
            det_scores = host(p["scores"], np.float32)
            det_labels = host(p["labels"], np.int64)
            gt_labels = host(t["labels"], np.int64)
            n_gt = gt_labels.shape[0]
            crowds = host(t.get("iscrowd", np.zeros(n_gt, np.int64)), np.int64).astype(bool)
            area = t.get("area")
            user_area = host(area, np.float32) if area is not None else np.zeros((0,), np.float32)
            if user_area.size != n_gt:
                user_area = np.full((n_gt,), -1.0, np.float32)
            derived = ((gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])).astype(np.float32)
            gt_area = np.where(user_area > 0, user_area, derived) if user_area.size else derived
            det_area = ((det_boxes[:, 2] - det_boxes[:, 0]) * (det_boxes[:, 3] - det_boxes[:, 1])).astype(np.float32)
            if self.average == "micro":
                det_labels = np.zeros_like(det_labels)
                gt_labels = np.zeros_like(gt_labels)
            for arr, what in ((det_labels, "preds"), (gt_labels, "target")):
                if arr.size and (arr.min() < 0 or arr.max() >= n_k):
                    raise ValueError(
                        f"approx='sketch' holds per-class histograms over a fixed class "
                        f"space [0, {n_k}); got a `{what}` label {int(arr.min()) if arr.min() < 0 else int(arr.max())}. "
                        "Raise `sketch_classes` to cover the label space."
                    )
            for cls in np.union1d(det_labels, gt_labels):
                d_sel = det_labels == cls
                g_sel = gt_labels == cls
                ious = _box_iou_crowd(det_boxes[d_sel], gt_boxes[g_sel], crowds[g_sel])
                tp, ig, sc, nv = _evaluate_image(ious, det_scores[d_sel], crowds[g_sel], gt_area[g_sel],
                                                 det_area[d_sel], self.iou_thresholds, arng, max_dets[-1])
                gt_total[cls] += nv
                det_total[cls] += sc.shape[0]
                if sc.shape[0]:
                    idx = sketch.cell_index(torch.from_numpy(sc)).numpy()
                    ti = np.broadcast_to(np.arange(n_t)[:, None], tp.shape)
                    ci = np.broadcast_to(idx[None, :], tp.shape)
                    np.add.at(h_tp[cls], (ti, ci), (tp & ~ig).astype(np.float32))
                    np.add.at(h_fp[cls], (ti, ci), (~tp & ~ig).astype(np.float32))
                for mi, mdet in enumerate(max_dets):
                    tp_count[mi, cls] += (tp[:, :mdet] & ~ig[:, :mdet]).sum(axis=1)
        out = {"score_hist_tp": h_tp, "score_hist_fp": h_fp, "tp_count": tp_count, "gt_total": gt_total,
               "det_total": det_total}
        return {name: torch.as_tensor(v, device=self.device) for name, v in out.items()}

    def _compute_sketch(self, state: State) -> Dict[str, Tensor]:
        """mAP/mAR from the sketch state, on the host in float64, as the JAX package computes them.

        Every histogram cell boundary is an exact operating point of the exact
        PR curve, so the interpolated AP over boundary points can only fall
        below the exact envelope, by at most ``max_b (pmax_b - pmin_b)`` a
        (class, threshold), where ``pmax_b`` removes cell b's own false
        positives from the denominator: the mean of that over the valid
        classes is the bound stamped for ``_gather_approx_provenance``. The
        area-banded keys are -1.
        """
        h_tp, h_fp, tp_count, gt_total, det_total = (
            state[name].cpu().numpy().astype(np.float64)
            for name in ("score_hist_tp", "score_hist_fp", "tp_count", "gt_total", "det_total"))
        rec_thrs, iou_thrs, mdt = self.rec_thresholds, self.iou_thresholds, self.max_detection_thresholds
        n_k, n_t, n_r = h_tp.shape[0], h_tp.shape[1], len(rec_thrs)
        # cumulative counts from the top score cell down: column j covers scores >= edges[C-1-j]
        tp_rev, fp_rev = h_tp[..., ::-1], h_fp[..., ::-1]
        tp_c, fp_c = np.cumsum(tp_rev, axis=-1), np.cumsum(fp_rev, axis=-1)
        valid_cls = gt_total > 0
        rc = tp_c / np.maximum(gt_total, 1.0)[:, None, None]
        pr = tp_c / np.maximum(tp_c + fp_c, np.spacing(1))
        pr_env = np.flip(np.maximum.accumulate(np.flip(pr, axis=-1), axis=-1), axis=-1)
        n_c = pr.shape[-1]
        precision = -np.ones((n_t, n_r, n_k))
        recall = -np.ones((n_t, n_k))
        for ki in range(n_k):
            if not valid_cls[ki]:
                continue
            for ti in range(n_t):
                inds = np.searchsorted(rc[ki, ti], rec_thrs, side="left")
                precision[ti, :, ki] = np.where(inds < n_c, pr_env[ki, ti, np.minimum(inds, n_c - 1)], 0.0)
            recall[:, ki] = tp_count[-1, ki] / gt_total[ki]
        # within cell b the exact envelope can exceed the boundary precision by at most pmax_b - pmin_b
        denom_max = np.maximum(tp_c + fp_c - fp_rev, np.spacing(1))
        diff = np.where(tp_c + fp_c > 0, tp_c / denom_max - pr, 0.0)
        per_kt = diff.max(axis=-1)  # (K, T)
        self.__dict__["_sketch_map_bound"] = float(per_kt[valid_cls].mean()) if valid_cls.any() else 0.0

        def mean_valid(x: np.ndarray) -> float:
            valid = x[x > -1]
            return float(valid.mean()) if valid.size else -1.0

        def ar(tpc_row: np.ndarray) -> float:  # (K, T) recall at one maxDets cap
            return mean_valid(np.where(gt_total[:, None] > 0, tpc_row / np.maximum(gt_total[:, None], 1.0), -1.0))

        res: Dict[str, float] = {
            "map": mean_valid(precision), "map_50": -1.0, "map_75": -1.0,
            "map_small": -1.0, "map_medium": -1.0, "map_large": -1.0,
            f"mar_{mdt[0]}": ar(tp_count[0]), f"mar_{mdt[1]}": ar(tp_count[1]), f"mar_{mdt[2]}": ar(tp_count[2]),
            "mar_small": -1.0, "mar_medium": -1.0, "mar_large": -1.0,
        }
        for thr, key in ((0.5, "map_50"), (0.75, "map_75")):
            sel = np.where(np.isclose(iou_thrs, thr))[0]
            if len(sel):
                res[key] = mean_valid(precision[sel])
        map_per_class: Union[float, np.ndarray] = -1.0
        mar_per_class: Union[float, np.ndarray] = -1.0
        observed = np.where(valid_cls | (det_total > 0))[0]
        if self.class_metrics and valid_cls.any():
            map_per_class = np.asarray([mean_valid(precision[:, :, ki]) for ki in observed], np.float32)
            mar_per_class = np.asarray([mean_valid(recall[:, ki]) for ki in observed], np.float32)
        out = {k: torch.tensor(v, dtype=torch.float32, device=self.device) for k, v in res.items()}
        out["map_per_class"] = torch.as_tensor(np.asarray(map_per_class, np.float32), device=self.device)
        out[f"mar_{mdt[-1]}_per_class"] = torch.as_tensor(np.asarray(mar_per_class, np.float32), device=self.device)
        out["classes"] = torch.as_tensor(observed.astype(np.int32).squeeze(), device=self.device)
        return out

    def _gather_approx_provenance(self) -> Optional[Dict[str, Any]]:
        """The sketch's provenance row, with the data-dependent mAP bound of the last ``compute`` (the grid's
        ``eps`` before one)."""
        if self._map_sketch is None:
            return None
        sketch = self._map_sketch
        return {
            "source": "gather_approx",
            "kind": "sketch-map",
            "bins": sketch.bins,
            "eps": float(sketch.eps),
            "classes": self.sketch_classes,
            "bound": float(self.__dict__.get("_sketch_map_bound", sketch.eps)),
        }

    # ---------------------------------------------------------- coco file io
    @staticmethod
    def coco_to_tm(
        coco_preds: str,
        coco_target: str,
        iou_type: Union[str, List[str]] = "bbox",
        backend: str = "native",
        device: Optional[Union[str, torch.device]] = None,
    ) -> Tuple[List[Dict[str, Tensor]], List[Dict[str, Tensor]]]:
        """This metric's input lists from COCO json files, as tensors on ``device`` (the card by default).

        Boxes come back in COCO xywh: construct the metric with
        ``box_format="xywh"`` to feed them. ``backend`` is accepted for the
        JAX package's signature; the parser is the native one.
        """
        from torchmetrics_tpu_torch.detection.coco_io import parse_coco_files

        device = resolve_device(device)
        preds, target = parse_coco_files(coco_preds, coco_target, iou_type)
        to_torch = lambda d: {k: torch.as_tensor(v, device=device) for k, v in d.items()}  # noqa: E731
        return [to_torch(p) for p in preds], [to_torch(t) for t in target]

    def tm_to_coco(self, name: str = "tm_map_input") -> None:
        """Write the accumulated inputs to ``{name}_preds.json`` and
        ``{name}_target.json`` in COCO format: boxes in COCO xywh, masks as
        compressed RLE."""
        import json

        from torchmetrics_tpu_torch.detection.coco_io import build_coco_dicts

        host = {name: [v.cpu().numpy() for v in value] for name, value in self._state.items()
                if isinstance(value, tuple)}
        has_boxes, has_masks = "bbox" in self.iou_types, "segm" in self.iou_types
        target_dict = build_coco_dicts(
            labels=host["groundtruth_labels"],
            boxes_xyxy=host["groundtruth_boxes"] if has_boxes else None,
            masks=host["groundtruth_masks"] if has_masks else None,
            crowds=host["groundtruth_crowds"],
            area=host["groundtruth_area"],
        )
        preds_dict = build_coco_dicts(
            labels=host["detection_labels"],
            boxes_xyxy=host["detection_boxes"] if has_boxes else None,
            masks=host["detection_masks"] if has_masks else None,
            scores=host["detection_scores"],
        )
        with open(f"{name}_target.json", "w") as handle:
            json.dump(target_dict, handle)
        with open(f"{name}_preds.json", "w") as handle:
            json.dump(preds_dict, handle)

    # -------------------------------------------------------------- compute
    def _mask_counts(self, state: State) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Each image's exact ``(inter (D, G), det_area (D,), gt_area (G,))`` from one ``mask_iou`` launch over
        every image (its plain version on the CPU)."""
        counts = mask_iou_counts(list(state["detection_masks"]), list(state["groundtruth_masks"]))
        return [tuple(c.cpu().numpy() for c in image) for image in counts]

    def _images(self, state: State, iou_type: str, counts) -> List[Dict[str, np.ndarray]]:
        """Each image's host arrays for one type's pass: scores, labels, crowds, areas and the full (D, G) IoUs.

        The derived ground-truth area is the masks' whenever ``segm`` is among the types and the boxes'
        otherwise: one area for every pass, as the JAX package keeps it."""
        images = []
        for i in range(len(state["detection_scores"])):
            host = {name: state[name][i].cpu().numpy() for name in _STATE_NAMES}
            crowd = host["groundtruth_crowds"].astype(bool)
            if iou_type == "bbox":
                det, gt = (state[k][i].cpu().numpy() for k in _ITEM_STATES["bbox"])
                box_areas = [((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])).astype(np.float32) for b in (det, gt)]
            if counts is not None:  # segm among the types
                inter, mask_det_area, mask_gt_area = counts[i]
                derived = mask_gt_area.astype(np.float32)
            else:
                derived = box_areas[1]
            if iou_type == "segm":
                ious = _mask_iou_from_counts(inter, mask_det_area, mask_gt_area, crowd)
                det_area = mask_det_area.astype(np.float32)
            else:
                ious = _box_iou_crowd(det, gt, crowd)
                det_area = box_areas[0]
            user = host["groundtruth_area"].reshape(-1)
            # per annotation: a positive user area wins, anything else is derived
            images.append({
                "det_scores": host["detection_scores"],
                "det_labels": host["detection_labels"],
                "gt_labels": host["groundtruth_labels"],
                "gt_crowd": crowd,
                "gt_area": np.where(user > 0, user, derived) if user.size else derived,
                "det_area": det_area,
                "ious": ious,
            })
        return images

    def _class_items(self, state: State, iou_type: str = "bbox", counts=None):
        """``(observed labels, classes, items)``: the state's (class, image)
        items, a list for each class, each detection list cut to the largest
        maxDets cap in score order."""
        images = self._images(state, iou_type, counts)
        labels = [r["det_labels"] for r in images] + [r["gt_labels"] for r in images]
        observed = sorted(set(np.concatenate(labels).tolist())) if images else []
        if self.average == "micro":  # one class for every label
            for r in images:
                r["det_labels"] = np.zeros_like(r["det_labels"])
                r["gt_labels"] = np.zeros_like(r["gt_labels"])
            classes = [0] if observed else []
        else:
            classes = observed
        max_det = self.max_detection_thresholds[-1]
        # (class, image) items, image by image: the IoUs of one image are
        # computed once and sliced per class (each IoU depends on its pair only)
        class_index = {c: k for k, c in enumerate(classes)}
        items: List[List[Dict[str, np.ndarray]]] = [[] for _ in classes]
        for ii, r in enumerate(images):
            for cls in np.unique(np.concatenate([r["det_labels"], r["gt_labels"]])).tolist():
                d_sel = np.nonzero(r["det_labels"] == cls)[0]
                g_sel = np.nonzero(r["gt_labels"] == cls)[0]
                d_scores = r["det_scores"][d_sel]
                d_order = np.argsort(-d_scores, kind="stable")[:max_det]
                items[class_index[cls]].append({
                    "ious": r["ious"][np.ix_(d_sel, g_sel)], "scores": d_scores, "crowd": r["gt_crowd"][g_sel],
                    "gt_area": r["gt_area"][g_sel], "det_area": r["det_area"][d_sel], "order": d_order, "image": ii,
                })
        return observed, classes, items

    def _compute(self, state: State) -> Dict[str, Any]:
        if self._map_sketch is not None:
            return self._compute_sketch(state)
        counts = self._mask_counts(state) if "segm" in self.iou_types else None
        out: Dict[str, Any] = {}
        for i_type in self.iou_types:
            prefix = "" if len(self.iou_types) == 1 else f"{i_type}_"
            for k, v in self._compute_one_type(state, i_type, counts).items():
                out[k if k == "classes" else f"{prefix}{k}"] = v  # ``classes`` is the same for every type
        return out

    def _compute_one_type(self, state: State, iou_type: str, counts) -> Dict[str, Any]:
        observed, classes, items = self._class_items(state, iou_type, counts)
        iou_thrs, rec_thrs, max_dets = self.iou_thresholds, self.rec_thresholds, self.max_detection_thresholds
        area_names = list(_AREA_RANGES)
        n_t, n_r, n_k, n_a, n_m = len(iou_thrs), len(rec_thrs), len(classes), len(area_names), len(max_dets)
        precision = -np.ones((n_t, n_r, n_k, n_a, n_m))
        recall = -np.ones((n_t, n_k, n_a, n_m))
        scores = -np.ones((n_t, n_r, n_k, n_a, n_m))

        if self.backend == "native":
            flat = [it for per_class in items for it in per_class]
            for it, (m, di) in zip(flat, match_batch_padded(_matcher_items(flat), iou_thrs, self.device)):
                it["matched"], it["det_ignored"] = m, di

        for ki, per_class in enumerate(items):
            if not per_class:
                continue
            cells = (self._cells_native if self.backend == "native" else self._cells_numpy)(per_class, max_dets)
            for (ai, mi), (tp, ig, sc, npig) in cells:
                if npig == 0:
                    continue
                recall[:, ki, ai, mi], precision[:, :, ki, ai, mi], scores[:, :, ki, ai, mi] = _accumulate(
                    tp, ig, sc, npig, rec_thrs)
        out = self._summarize(precision, recall, iou_thrs, area_names, max_dets, observed)
        if self.extended_summary:
            out["precision"] = torch.as_tensor(precision, dtype=torch.float32, device=self.device)
            out["recall"] = torch.as_tensor(recall, dtype=torch.float32, device=self.device)
            out["scores"] = torch.as_tensor(scores, dtype=torch.float32, device=self.device)
            # the (image, class) IoU matrices, as COCOeval.ious: (0, 0) where the image holds none of the class
            n_images = len(state["detection_scores"])
            ious = {(ii, classes[ki]): np.zeros((0, 0)) for ki in range(n_k) for ii in range(n_images)}
            for ki, per_class in enumerate(items):
                for it in per_class:
                    ious[(it["image"], classes[ki])] = it["ious"]
            out["ious"] = {key: torch.as_tensor(v, dtype=torch.float32, device=self.device) for key, v in ious.items()}
        return out

    def _cells_native(self, per_class, max_dets):
        """``((area, maxDets), (tp, ig, scores, n_valid_gt))`` of one class
        from the matcher's output: its images concatenated once, each cap
        selected by a detection's rank in its image. The area bounds are
        Python floats here and arrays in the matcher's ignore masks, as in the
        JAX package."""
        scores = np.concatenate([it["scores"][it["order"]] for it in per_class])
        det_area = np.concatenate([it["det_area"][it["order"]] for it in per_class])
        rank = np.concatenate([np.arange(len(it["order"])) for it in per_class])
        matched = np.concatenate([it["matched"] for it in per_class], axis=2)  # (A, T, sum D)
        det_ig = np.concatenate([it["det_ignored"] for it in per_class], axis=2)
        crowd = np.concatenate([it["crowd"] for it in per_class])
        gt_area = np.concatenate([it["gt_area"] for it in per_class])
        for ai, (lo, hi) in enumerate(_AREA_RANGES.values()):
            npig = int((~(crowd | (gt_area < lo) | (gt_area > hi))).sum())
            out_rng = (det_area < lo) | (det_area > hi)
            for mi, mdet in enumerate(max_dets):
                sel = rank < mdet
                tp = matched[ai][:, sel]
                ig = det_ig[ai][:, sel] | (~tp & out_rng[sel][None, :])
                yield (ai, mi), (tp, ig, scores[sel], npig)

    def _cells_numpy(self, per_class, max_dets):
        """The same cells from ``_evaluate_image``, image by image."""
        for ai, arng in enumerate(_AREA_RANGES.values()):
            for mi, mdet in enumerate(max_dets):
                tps, igs, scs, npig = [], [], [], 0
                for it in per_class:
                    tp, ig, sc, nv = _evaluate_image(
                        it["ious"], it["scores"], it["crowd"], it["gt_area"], it["det_area"],
                        self.iou_thresholds, arng, mdet,
                    )
                    tps.append(tp)
                    igs.append(ig)
                    scs.append(sc)
                    npig += nv
                yield (ai, mi), (np.concatenate(tps, axis=1), np.concatenate(igs, axis=1), np.concatenate(scs), npig)

    def _summarize(self, precision, recall, iou_thrs, area_names, max_dets, observed) -> Dict[str, Tensor]:
        def mean_valid(s: np.ndarray) -> float:
            valid = s[s > -1]
            return float(valid.mean()) if valid.size else -1.0

        def summarize(ap: bool, iou_thr: Optional[float] = None, area: str = "all", mdet: int = 100) -> float:
            ai, mi = area_names.index(area), max_dets.index(mdet)
            s = precision[:, :, :, ai, mi] if ap else recall[:, :, ai, mi]
            if iou_thr is not None:
                sel = np.where(np.isclose(iou_thrs, iou_thr))[0]
                if len(sel) == 0:
                    return -1.0
                s = s[sel]
            return mean_valid(s)

        mdt = max_dets
        res = {
            "map": summarize(True, None, "all", mdt[-1]),
            "map_50": summarize(True, 0.5, "all", mdt[-1]),
            "map_75": summarize(True, 0.75, "all", mdt[-1]),
            "map_small": summarize(True, None, "small", mdt[-1]),
            "map_medium": summarize(True, None, "medium", mdt[-1]),
            "map_large": summarize(True, None, "large", mdt[-1]),
            f"mar_{mdt[0]}": summarize(False, None, "all", mdt[0]),
            f"mar_{mdt[1]}": summarize(False, None, "all", mdt[1]),
            f"mar_{mdt[2]}": summarize(False, None, "all", mdt[2]),
            "mar_small": summarize(False, None, "small", mdt[-1]),
            "mar_medium": summarize(False, None, "medium", mdt[-1]),
            "mar_large": summarize(False, None, "large", mdt[-1]),
        }
        map_per_class: Union[float, np.ndarray] = -1.0
        mar_per_class: Union[float, np.ndarray] = -1.0
        n_k = precision.shape[2]
        if self.class_metrics and n_k:
            ai, mi = area_names.index("all"), max_dets.index(mdt[-1])
            map_per_class = np.asarray([mean_valid(precision[:, :, k, ai, mi]) for k in range(n_k)], np.float32)
            mar_per_class = np.asarray([mean_valid(recall[:, k, ai, mi]) for k in range(n_k)], np.float32)
        out = {k: torch.tensor(v, dtype=torch.float32, device=self.device) for k, v in res.items()}
        out["map_per_class"] = torch.as_tensor(np.asarray(map_per_class, np.float32), device=self.device)
        out[f"mar_{mdt[-1]}_per_class"] = torch.as_tensor(np.asarray(mar_per_class, np.float32), device=self.device)
        out["classes"] = torch.as_tensor(np.asarray(observed, np.int32).squeeze(), device=self.device)
        return out
