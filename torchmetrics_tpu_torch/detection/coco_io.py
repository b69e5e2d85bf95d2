"""COCO-format json <-> metric-input conversion (the port's own copy of
``torchmetrics_tpu/detection/coco_io.py``; pure numpy and json).

* result-list / instances-dict json parsing and per-image grouping;
* the COCO RLE mask codec: column-major run lengths, with the compressed
  ``counts`` string in the cocoapi's 6-bits-a-char (+48 offset,
  sign-extended, delta-from-two-back) variable-length integer encoding,
  byte for byte the JAX package's;
* polygon segmentations rasterized through matplotlib's path test (pixel
  centres inside a polygon), which needs matplotlib.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np

__all__ = ["rle_decode", "rle_encode", "ann_to_mask", "parse_coco_files", "build_coco_dicts"]


# ------------------------------------------------------------------ RLE codec
def _counts_from_string(s: str) -> List[int]:
    """Decode the compressed ``counts`` string: 5 payload bits per char
    (ASCII - 48), bit 0x20 = continuation, sign-extended, and each count
    after the second stored as a delta from the count two positions back."""
    counts: List[int] = []
    pos = 0
    while pos < len(s):
        value = 0
        shift = 0
        while True:
            chunk = ord(s[pos]) - 48
            value |= (chunk & 0x1F) << shift
            shift += 5
            pos += 1
            if not chunk & 0x20:
                if chunk & 0x10:
                    value |= -1 << shift  # sign extension
                break
        if len(counts) > 2:
            value += counts[-2]
        counts.append(value)
    return counts


def _counts_to_string(counts: Sequence[int]) -> str:
    """Inverse of :func:`_counts_from_string`."""
    out: List[str] = []
    for i, count in enumerate(counts):
        value = count if i <= 2 else count - counts[i - 2]
        while True:
            chunk = value & 0x1F
            value >>= 5
            # done when the remaining bits are pure sign fill AND the sign
            # bit of this chunk agrees with them
            more = not (value == 0 and not chunk & 0x10 or value == -1 and chunk & 0x10)
            if more:
                chunk |= 0x20
            out.append(chr(chunk + 48))
            if not more:
                break
    return "".join(out)


def rle_decode(rle: Dict[str, Any]) -> np.ndarray:
    """COCO RLE dict -> (H, W) uint8 mask.  Runs are column-major and start
    with the zero run."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _counts_from_string(counts.decode() if isinstance(counts, bytes) else counts)
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    value = 0
    for run in counts:
        flat[pos : pos + run] = value
        pos += run
        value = 1 - value
    return flat.reshape(w, h).T


def rle_encode(mask: np.ndarray, compress: bool = True) -> Dict[str, Any]:
    """(H, W) binary mask -> COCO RLE dict (compressed string by default)."""
    mask = np.asarray(mask).astype(bool)
    h, w = mask.shape
    flat = mask.T.reshape(-1)
    # run-length encode, first run counts zeros
    changes = np.nonzero(np.diff(flat))[0] + 1
    boundaries = np.concatenate([[0], changes, [flat.size]])
    counts = np.diff(boundaries).tolist()
    if flat.size and flat[0]:
        counts = [0] + counts
    if not flat.size:
        counts = [0]
    return {"size": [h, w], "counts": _counts_to_string(counts) if compress else counts}


def ann_to_mask(ann: Dict[str, Any], height: int, width: int) -> np.ndarray:
    """COCO annotation segmentation (RLE dict, uncompressed RLE, or polygon
    list) -> (H, W) uint8 mask.  Mirror of pycocotools ``annToMask``."""
    seg = ann["segmentation"]
    if isinstance(seg, dict):
        return rle_decode(seg)
    if isinstance(seg, list):  # polygon(s): [[x1, y1, x2, y2, ...], ...]
        try:
            from matplotlib.path import Path
        except ImportError as err:
            raise ModuleNotFoundError(
                "Rasterizing polygon segmentations requires matplotlib; convert the "
                "annotations to RLE, or install matplotlib."
            ) from err

        ys, xs = np.mgrid[:height, :width]
        points = np.stack([xs.ravel() + 0.5, ys.ravel() + 0.5], axis=1)
        mask = np.zeros(height * width, dtype=bool)
        for poly in seg:
            vertices = np.asarray(poly, np.float64).reshape(-1, 2)
            mask |= Path(vertices).contains_points(points)
        return mask.reshape(height, width).astype(np.uint8)
    raise ValueError(f"Unsupported segmentation format: {type(seg)}")


# ------------------------------------------------------ json <-> input dicts
def _load_annotations(path: str) -> Tuple[List[Dict[str, Any]], Dict[int, Dict[str, Any]]]:
    """Load a COCO file: full instances dict OR bare result list.  Returns
    (annotations, images-by-id)."""
    with open(path) as handle:
        data = json.load(handle)
    if isinstance(data, list):
        return data, {}
    images = {img["id"]: img for img in data.get("images", [])}
    return data.get("annotations", []), images


def parse_coco_files(
    coco_preds: str,
    coco_target: str,
    iou_type: Union[str, Sequence[str]] = "bbox",
) -> Tuple[List[Dict[str, np.ndarray]], List[Dict[str, np.ndarray]]]:
    """Parse (predictions, target) COCO jsons into this metric's input lists
    (``MeanAveragePrecision.coco_to_tm``)."""
    iou_types = (iou_type,) if isinstance(iou_type, str) else tuple(iou_type)
    gt_anns, gt_images = _load_annotations(coco_target)
    dt_anns, _ = _load_annotations(coco_preds)

    def image_hw(image_id: int, ann: Dict[str, Any]) -> Tuple[int, int]:
        meta = gt_images.get(image_id, {})
        if "height" in meta:
            return int(meta["height"]), int(meta["width"])
        seg = ann.get("segmentation")
        if isinstance(seg, dict):
            return tuple(seg["size"])  # type: ignore[return-value]
        raise ValueError(
            f"Cannot infer mask size for image {image_id}: no image metadata and no RLE size."
        )

    def new_entry(with_score: bool) -> Dict[str, list]:
        entry: Dict[str, list] = {"labels": []}
        if with_score:
            entry["scores"] = []
        else:
            entry["iscrowd"] = []
            entry["area"] = []
        if "bbox" in iou_types:
            entry["boxes"] = []
        if "segm" in iou_types:
            entry["masks"] = []
        return entry

    target: Dict[int, Dict[str, list]] = {}
    for ann in gt_anns:
        entry = target.setdefault(ann["image_id"], new_entry(with_score=False))
        entry["labels"].append(ann["category_id"])
        entry["iscrowd"].append(ann.get("iscrowd", 0))
        if "bbox" in iou_types:
            entry["boxes"].append(ann["bbox"])
        mask = None
        if "segm" in iou_types:
            mask = ann_to_mask(ann, *image_hw(ann["image_id"], ann))
            entry["masks"].append(mask)
        if "area" in ann:
            area = float(ann["area"])
        elif mask is not None:
            # pycocotools derives area from the decoded mask when the
            # annotation carries none (maskUtils.area precedence)
            area = float(np.asarray(mask).sum())
        elif "bbox" in ann:
            area = float(ann["bbox"][2] * ann["bbox"][3])
        else:
            area = 0.0
        entry["area"].append(area)

    preds: Dict[int, Dict[str, list]] = {}
    for ann in dt_anns:
        entry = preds.setdefault(ann["image_id"], new_entry(with_score=True))
        entry["labels"].append(ann["category_id"])
        entry["scores"].append(ann["score"])
        if "bbox" in iou_types:
            entry["boxes"].append(ann["bbox"])
        if "segm" in iou_types:
            entry["masks"].append(ann_to_mask(ann, *image_hw(ann["image_id"], ann)))

    batched_preds, batched_target = [], []
    for image_id in target:
        p = preds.get(image_id, new_entry(with_score=True))
        bp = {
            "scores": np.asarray(p["scores"], np.float32),
            "labels": np.asarray(p["labels"], np.int32),
        }
        bt = {
            "labels": np.asarray(target[image_id]["labels"], np.int32),
            "iscrowd": np.asarray(target[image_id]["iscrowd"], np.int32),
            "area": np.asarray(target[image_id]["area"], np.float32),
        }
        if "bbox" in iou_types:
            bp["boxes"] = np.asarray(p["boxes"], np.float32).reshape(-1, 4)
            bt["boxes"] = np.asarray(target[image_id]["boxes"], np.float32).reshape(-1, 4)
        if "segm" in iou_types:
            bp["masks"] = np.asarray(p["masks"], np.uint8).reshape(len(p["masks"]), *(
                p["masks"][0].shape if p["masks"] else (0, 0)))
            bt["masks"] = np.asarray(target[image_id]["masks"], np.uint8)
        batched_preds.append(bp)
        batched_target.append(bt)
    return batched_preds, batched_target


def build_coco_dicts(
    *,
    labels: Sequence[np.ndarray],
    boxes_xyxy: Sequence[np.ndarray] = None,
    masks: Sequence[np.ndarray] = None,
    scores: Sequence[np.ndarray] = None,
    crowds: Sequence[np.ndarray] = None,
    area: Sequence[np.ndarray] = None,
) -> Dict[str, Any]:
    """Per-image state arrays -> a COCO instances dict (``MeanAveragePrecision.tm_to_coco``).  Boxes convert
    xyxy -> xywh; masks encode to compressed RLE."""
    images = []
    annotations = []
    ann_id = 1
    for i, image_labels in enumerate(labels):
        image = {"id": i}
        if masks is not None and len(masks) > i and len(masks[i]):
            image["height"] = int(masks[i].shape[-2])
            image["width"] = int(masks[i].shape[-1])
        images.append(image)
        for j, label in enumerate(np.asarray(image_labels).tolist()):
            ann: Dict[str, Any] = {"id": ann_id, "image_id": i, "category_id": int(label)}
            if boxes_xyxy is not None and len(boxes_xyxy) > i:
                x1, y1, x2, y2 = (float(v) for v in np.asarray(boxes_xyxy[i])[j])
                ann["bbox"] = [x1, y1, x2 - x1, y2 - y1]
                ann["area"] = (x2 - x1) * (y2 - y1)
            if masks is not None and len(masks) > i and len(masks[i]):
                mask = np.asarray(masks[i][j])
                ann["segmentation"] = rle_encode(mask)
                ann.setdefault("area", float(mask.sum()))
            if area is not None and len(area) > i:
                recorded = float(np.asarray(area[i])[j])
                if recorded >= 0:
                    ann["area"] = recorded
            if crowds is not None and len(crowds) > i:
                ann["iscrowd"] = int(np.asarray(crowds[i])[j])
            if scores is not None and len(scores) > i:
                ann["score"] = float(np.asarray(scores[i])[j])
            annotations.append(ann)
            ann_id += 1
    categories = [
        {"id": int(c)} for c in sorted({int(v) for arr in labels for v in np.asarray(arr).tolist()})
    ]
    return {"images": images, "annotations": annotations, "categories": categories}
