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

This slice ports ``iou_type="bbox"``. ``segm``, ``approx="sketch"``, the
COCO file I/O and ``extended_summary`` are not ported yet and raise.

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
from torchmetrics_tpu_torch.functional.detection.matcher import match_batch_padded

_AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}

_STATE_NAMES = ("detection_scores", "detection_labels", "groundtruth_labels", "groundtruth_crowds",
                "groundtruth_area", "detection_boxes", "groundtruth_boxes")


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
    ``(recall (T,), precision (T, R))`` from the score-ordered matches."""
    order = np.argsort(-scores, kind="mergesort")
    tp, ig = tp[:, order], ig[:, order]
    tp_cum = np.cumsum(tp & ~ig, axis=1).astype(np.float64)
    fp_cum = np.cumsum(~tp & ~ig, axis=1).astype(np.float64)
    n_t, nd = tp_cum.shape
    rc = tp_cum / npig
    pr = tp_cum / np.maximum(fp_cum + tp_cum, np.spacing(1))
    if not nd:
        return np.zeros(n_t), np.zeros((n_t, len(rec_thrs)))
    # monotone precision envelope from the right: a reversed running max
    pr_env = np.flip(np.maximum.accumulate(np.flip(pr, axis=1), axis=1), axis=1)
    inds = np.stack([np.searchsorted(rc[ti], rec_thrs, side="left") for ti in range(n_t)])
    hit = inds < nd
    safe = np.minimum(inds, nd - 1)
    return rc[:, -1], np.where(hit, np.take_along_axis(pr_env, safe, axis=1), 0.0)


class MeanAveragePrecision(Metric):
    """COCO mAP/mAR of box detections."""

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
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if box_format not in ("xyxy", "xywh", "cxcywh"):
            raise ValueError(f"Expected argument `box_format` to be one of ('xyxy', 'xywh', 'cxcywh') but got {box_format}")
        iou_types = (iou_type,) if isinstance(iou_type, str) else tuple(iou_type)
        for it in iou_types:
            if it not in ("bbox", "segm"):
                raise ValueError(f"Expected argument `iou_type` to be one of ('bbox', 'segm') but got {it}")
        if iou_types != ("bbox",) or extended_summary:
            raise NotImplementedError("MeanAveragePrecision: only iou_type='bbox' without extended_summary is ported")
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        if average not in ("macro", "micro"):
            raise ValueError(f"Expected argument `average` to be one of ('macro', 'micro') but got {average}")
        if backend not in ("native", "native_numpy"):
            raise ValueError(f"Expected argument `backend` to be one of ('native', 'native_numpy') but got {backend}")
        self.box_format = box_format
        self.iou_type = "bbox"
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
        self.average = average
        self.backend = backend
        for name in _STATE_NAMES:
            self.add_state(name, [], dist_reduce_fx=None)

    # -------------------------------------------------------------- update
    def _update(self, state: State, preds: List[Dict[str, Tensor]], target: List[Dict[str, Tensor]]) -> State:
        if not isinstance(preds, Sequence) or not isinstance(target, Sequence):
            raise ValueError("Expected argument `preds` and `target` to be a sequence of dicts")
        if len(preds) != len(target):
            raise ValueError("Expected argument `preds` and `target` to have the same length")
        for p in preds:
            for k in ("boxes", "scores", "labels"):
                if k not in p:
                    raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")
        for t in target:
            for k in ("boxes", "labels"):
                if k not in t:
                    raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")
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
            else:  # sentinel: the area is derived from the box at compute
                area = torch.full((n_gt,), -1.0, dtype=torch.float32, device=self.device)
            add("detection_boxes", self._convert_boxes(p["boxes"]))
            add("groundtruth_boxes", self._convert_boxes(t["boxes"]))
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

    # -------------------------------------------------------------- compute
    def _images(self, state: State) -> List[Dict[str, np.ndarray]]:
        images = []
        for i in range(len(state["detection_boxes"])):
            host = {name: state[name][i].cpu().numpy() for name in _STATE_NAMES}
            det, gt = host["detection_boxes"], host["groundtruth_boxes"]
            derived = ((gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])).astype(np.float32)
            user = host["groundtruth_area"].reshape(-1)
            # per annotation: a positive user area wins, anything else is derived
            images.append({
                "det_boxes": det,
                "det_scores": host["detection_scores"],
                "det_labels": host["detection_labels"],
                "gt_boxes": gt,
                "gt_labels": host["groundtruth_labels"],
                "gt_crowd": host["groundtruth_crowds"].astype(bool),
                "gt_area": np.where(user > 0, user, derived) if user.size else derived,
                "det_area": ((det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])).astype(np.float32),
            })
        return images

    def _class_items(self, state: State):
        """``(observed labels, classes, items)``: the state's (class, image)
        items, a list for each class, each detection list cut to the largest
        maxDets cap in score order."""
        images = self._images(state)
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
        for r in images:
            ious = _box_iou_crowd(r["det_boxes"], r["gt_boxes"], r["gt_crowd"])
            for cls in np.unique(np.concatenate([r["det_labels"], r["gt_labels"]])).tolist():
                d_sel = np.nonzero(r["det_labels"] == cls)[0]
                g_sel = np.nonzero(r["gt_labels"] == cls)[0]
                d_scores = r["det_scores"][d_sel]
                d_order = np.argsort(-d_scores, kind="stable")[:max_det]
                items[class_index[cls]].append({
                    "ious": ious[np.ix_(d_sel, g_sel)], "scores": d_scores, "crowd": r["gt_crowd"][g_sel],
                    "gt_area": r["gt_area"][g_sel], "det_area": r["det_area"][d_sel], "order": d_order,
                })
        return observed, classes, items

    def _compute(self, state: State) -> Dict[str, Tensor]:
        observed, classes, items = self._class_items(state)
        iou_thrs, rec_thrs, max_dets = self.iou_thresholds, self.rec_thresholds, self.max_detection_thresholds
        area_names = list(_AREA_RANGES)
        n_t, n_r, n_k, n_a, n_m = len(iou_thrs), len(rec_thrs), len(classes), len(area_names), len(max_dets)
        precision = -np.ones((n_t, n_r, n_k, n_a, n_m))
        recall = -np.ones((n_t, n_k, n_a, n_m))

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
                recall[:, ki, ai, mi], precision[:, :, ki, ai, mi] = _accumulate(tp, ig, sc, npig, rec_thrs)
        return self._summarize(precision, recall, iou_thrs, area_names, max_dets, observed)

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
