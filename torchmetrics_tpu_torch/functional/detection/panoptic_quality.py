"""Panoptic Quality (counterpart of ``torchmetrics_tpu/functional/detection/panoptic_quality.py``).

Inputs are ``(B, *spatial, 2)`` tensors of (category_id, instance_id)
pairs. Each image runs on the inputs' device: its pred and target
(category, instance) codes become dense segment ids (``torch.unique`` of the
int64 codes), the (pred segment, target segment) contingency table is
counted by the ``confmat_multiclass`` CUDA kernel in labels mode on the card
(its plain version on the CPU), as the clustering contingency is
(:func:`~torchmetrics_tpu_torch.functional.clustering.utils._pair_table`),
and every matching rule of the JAX package (IoU above 0.5, the void rows and
columns, the false positives and negatives at most half void, the modified
metric's stuffs) is a tensor operation on that table. Pairs of dense ids are
encoded, never ``p_code * base + t_code``, which COCO-panoptic's RGB-encoded
instance ids (about 1.6e7) would overflow in int64.

The IoU sums add in another order than the JAX package's (``np.unique``'s
pair order): the counts are equal, the float64 sums equal within rounding.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.detection.panoptic_quality import panoptic_quality
    >>> preds = torch.tensor([[[[6, 0], [0, 0]], [[6, 0], [7, 0]]]])
    >>> target = torch.tensor([[[[6, 0], [0, 1]], [[6, 0], [7, 0]]]])
    >>> round(float(panoptic_quality(preds, target, things={0, 1}, stuffs={6, 7})), 4)
    1.0
"""

from __future__ import annotations

from typing import Any, Collection, Dict, Optional, Set, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.clustering.utils import _pair_table
from torchmetrics_tpu_torch.utilities.data import input_device


def _parse_categories(things: Collection[int], stuffs: Collection[int]) -> Tuple[Set[int], Set[int]]:
    things_parsed = set(int(t) for t in things)
    stuffs_parsed = set(int(s) for s in stuffs)
    if not things_parsed and not stuffs_parsed:
        raise ValueError("At least one of `things` and `stuffs` must be non-empty.")
    if things_parsed & stuffs_parsed:
        raise ValueError(
            f"Expected arguments `things` and `stuffs` to have distinct keys, but got {things} and {stuffs}."
        )
    return things_parsed, stuffs_parsed


def _get_void_color(things: Set[int], stuffs: Set[int]) -> Tuple[int, int]:
    unused_category_id = 1 + max([0, *list(things), *list(stuffs)])
    return unused_category_id, 0


def _ids(values: Collection[int], device: torch.device) -> Tensor:
    return torch.tensor(sorted(values), dtype=torch.int64, device=device)


def _preprocess_inputs(
    things: Set[int],
    stuffs: Set[int],
    inputs: Tensor,
    void_color: Tuple[int, int],
    allow_unknown_category: bool,
) -> Tensor:
    """``(B, P, 2)`` int64: spatial dims flattened, stuff instance ids zeroed,
    unknown categories mapped to void (or raising)."""
    out = inputs.reshape(inputs.shape[0], -1, 2).to(torch.int64)
    cat, inst = out[..., 0], out[..., 1]
    mask_stuffs = torch.isin(cat, _ids(stuffs, out.device))
    known = torch.isin(cat, _ids(things, out.device)) | mask_stuffs
    inst = torch.where(mask_stuffs, 0, inst)
    if not allow_unknown_category and not bool(known.all()):
        raise ValueError(f"Unknown categories found: {out[~known]}")
    return torch.stack([torch.where(known, cat, void_color[0]), torch.where(known, inst, void_color[1])], dim=-1)


def _continuous_ids(cats: Tensor, cat_id_to_continuous_id: Dict[int, int]) -> Tuple[Tensor, Tensor]:
    """Each category id's continuous id, and whether the map holds the category.

    A category outside the map (a segment with a negative instance id falls one category below its own:
    ``code // base``) gets continuous id 0; :func:`_raise_out_of_map` refuses it wherever it would be booked.
    """
    keys = torch.tensor(sorted(cat_id_to_continuous_id), dtype=torch.int64, device=cats.device)
    values = torch.tensor([cat_id_to_continuous_id[k] for k in keys.tolist()], dtype=torch.int64, device=cats.device)
    pos = torch.searchsorted(keys, cats).clamp_max(keys.numel() - 1)
    return values[pos], keys[pos] == cats


def _raise_out_of_map(looked_up: Tuple[Tensor, ...], cats: Tuple[Tensor, ...]) -> None:
    """``KeyError`` naming the first category that a lookup of the JAX package's dict would miss.

    ``looked_up[i]`` marks the segments whose category ``cats[i]`` is looked up and lies outside the map, in the
    JAX package's order: matching pairs, then false negatives, then false positives. It reads the device once
    when no lookup misses.
    """
    if not bool(torch.stack([m.any() for m in looked_up]).any()):
        return
    for mask, cat in zip(looked_up, cats):
        if bool(mask.any()):
            raise KeyError(int(cat[mask].min()))


def _panoptic_quality_update_sample(
    flat_preds: Tensor,
    flat_target: Tensor,
    cat_id_to_continuous_id: Dict[int, int],
    void_color: Tuple[int, int],
    stuffs_modified_metric: Optional[Set[int]] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """One image's ``(iou_sum float64, tp, fp, fn int64)`` a continuous category, from ``(P, 2)`` inputs."""
    stuffs_modified_metric = stuffs_modified_metric or set()
    device = flat_preds.device
    n_cat = len(cat_id_to_continuous_id)
    base = int(torch.stack([flat_preds[:, 1].max(), flat_target[:, 1].max()]).max()) if flat_preds.numel() else 0
    base = max(base, void_color[1], 0) + 2
    void_code = void_color[0] * base + void_color[1]
    p_codes, p_ids = torch.unique(flat_preds[:, 0] * base + flat_preds[:, 1], return_inverse=True)
    t_codes, t_ids = torch.unique(flat_target[:, 0] * base + flat_target[:, 1], return_inverse=True)
    table = _pair_table(p_ids, t_ids, p_codes.numel(), t_codes.numel()).to(torch.int64)  # [pred, target]

    pred_areas, target_areas = table.sum(1), table.sum(0)
    p_void, t_void = p_codes == void_code, t_codes == void_code
    pred_void = (table * t_void[None, :]).sum(1)  # each pred segment's pixels on void target
    void_target = (table * p_void[:, None]).sum(0)  # each target segment's pixels on void pred
    p_cat, t_cat = torch.div(p_codes, base, rounding_mode="floor"), torch.div(t_codes, base, rounding_mode="floor")
    (p_cont, p_known), (t_cont, t_known) = (_continuous_ids(c, cat_id_to_continuous_id) for c in (p_cat, t_cat))
    modified = _ids(stuffs_modified_metric, device)
    p_mod, t_mod = torch.isin(p_cat, modified), torch.isin(t_cat, modified)

    union = pred_areas[:, None] - pred_void[:, None] + target_areas[None, :] - void_target[None, :] - table
    iou = torch.where(union != 0, table.to(torch.float64) / union.clamp_min(1).to(torch.float64), 0.0)
    pair = (table > 0) & ~t_void[None, :] & (p_cat[:, None] == t_cat[None, :])
    match = pair & ~t_mod[None, :] & (iou > 0.5)
    stuff = pair & t_mod[None, :] & (iou > 0)
    cols = t_cont[None, :].expand_as(table)
    # false negatives and positives: unmatched segments at most half void (the modified stuffs are counted apart)
    fn_any = ~match.any(0) & ~t_void & (void_target.to(torch.float64) / target_areas.to(torch.float64) <= 0.5)
    fp_any = ~match.any(1) & ~p_void & (pred_void.to(torch.float64) / pred_areas.to(torch.float64) <= 0.5)
    # the JAX package looks each pair's category up, then each such unmatched segment's; a modified stuff's
    # lookup cannot miss (the map holds every stuff)
    _raise_out_of_map((pair.any(0) & ~t_known, fn_any & ~t_known, fp_any & ~p_known), (t_cat, t_cat, p_cat))

    iou_sum = torch.zeros(n_cat, dtype=torch.float64, device=device)
    iou_sum.index_add_(0, cols[match | stuff], iou[match | stuff])
    tp = torch.zeros(n_cat, dtype=torch.int64, device=device)
    tp.index_add_(0, cols[match], torch.ones_like(cols[match]))
    # the modified metric: every target segment of a modified stuff counts as one true positive
    tp.index_add_(0, t_cont[t_mod], torch.ones_like(t_cont[t_mod]))
    fn_sel, fp_sel = fn_any & ~t_mod, fp_any & ~p_mod
    fn = torch.zeros(n_cat, dtype=torch.int64, device=device)
    fn.index_add_(0, t_cont[fn_sel], torch.ones_like(t_cont[fn_sel]))
    fp = torch.zeros(n_cat, dtype=torch.int64, device=device)
    fp.index_add_(0, p_cont[fp_sel], torch.ones_like(p_cont[fp_sel]))
    return iou_sum, tp, fp, fn


def _panoptic_quality_update(
    flatten_preds: Tensor,
    flatten_target: Tensor,
    cat_id_to_continuous_id: Dict[int, int],
    void_color: Tuple[int, int],
    modified_metric_stuffs: Optional[Set[int]] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The batch's ``(iou_sum, tp, fp, fn)``: the images' sums."""
    n_cat = len(cat_id_to_continuous_id)
    device = flatten_preds.device
    iou_sum = torch.zeros(n_cat, dtype=torch.float64, device=device)
    tp, fp, fn = (torch.zeros(n_cat, dtype=torch.int64, device=device) for _ in range(3))
    for b in range(flatten_preds.shape[0]):
        r = _panoptic_quality_update_sample(flatten_preds[b], flatten_target[b], cat_id_to_continuous_id, void_color,
                                            modified_metric_stuffs)
        iou_sum += r[0]
        tp += r[1]
        fp += r[2]
        fn += r[3]
    return iou_sum, tp, fp, fn


def _panoptic_quality_compute(
    iou_sum: Tensor, tp: Tensor, fp: Tensor, fn: Tensor
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """``(pq, sq, rq)`` a category and their means over the categories with a non-zero denominator (0 when none
    has one), in the dtype of ``iou_sum`` and the counts."""
    tp, fp, fn = (x.to(iou_sum.dtype) for x in (tp, fp, fn))  # numpy's promotion: float64 sums, float32 states
    sq = torch.where(tp > 0, iou_sum / torch.clamp(tp, min=1), 0.0)
    denominator = tp + 0.5 * fp + 0.5 * fn
    rq = torch.where(denominator > 0, tp / torch.clamp(denominator, min=1e-12), 0.0)
    pq = sq * rq
    sel = denominator > 0
    zero = torch.zeros((), dtype=pq.dtype, device=pq.device)
    averages = [v[sel].mean() if bool(sel.any()) else zero for v in (pq, sq, rq)]
    return (pq, sq, rq, *averages)


def _pq_result(values: Tuple[Tensor, ...], return_sq_and_rq: bool, return_per_class: bool) -> Tensor:
    pq, sq, rq, pq_avg, sq_avg, rq_avg = (v.to(torch.float32) for v in values)
    if return_per_class:
        return (torch.stack([pq, sq, rq], dim=-1) if return_sq_and_rq else pq)[None]
    return torch.stack([pq_avg, sq_avg, rq_avg]) if return_sq_and_rq else pq_avg


def _check_inputs(preds: Tensor, target: Tensor) -> None:
    if preds.ndim < 3 or preds.shape[-1] != 2:
        raise ValueError(f"Expected argument `preds` to have shape (B, *spatial, 2) but got {tuple(preds.shape)}")
    if target.shape != preds.shape:
        raise ValueError(
            "Expected argument `preds` and `target` to have the same shape, but got "
            f"{tuple(preds.shape)} and {tuple(target.shape)}"
        )


def _pq_pipeline(
    preds: Any,
    target: Any,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool,
    modified: bool,
    return_sq_and_rq: bool,
    return_per_class: bool,
) -> Tensor:
    things_s, stuffs_s = _parse_categories(things, stuffs)
    device = input_device(preds)
    preds = torch.as_tensor(preds, device=device)
    target = torch.as_tensor(target, device=device)
    _check_inputs(preds, target)
    void_color = _get_void_color(things_s, stuffs_s)
    cat_id_to_continuous_id = {c: i for i, c in enumerate([*sorted(things_s), *sorted(stuffs_s)])}
    flat_preds = _preprocess_inputs(things_s, stuffs_s, preds, void_color, allow_unknown_preds_category)
    # unknown target categories always map to void
    flat_target = _preprocess_inputs(things_s, stuffs_s, target, void_color, True)
    counts = _panoptic_quality_update(flat_preds, flat_target, cat_id_to_continuous_id, void_color,
                                      modified_metric_stuffs=stuffs_s if modified else None)
    return _pq_result(_panoptic_quality_compute(*counts), return_sq_and_rq, return_per_class)


def panoptic_quality(
    preds: Any,
    target: Any,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
    return_sq_and_rq: bool = False,
    return_per_class: bool = False,
) -> Tensor:
    """Panoptic quality, or with ``return_sq_and_rq`` ``(PQ, SQ, RQ)``, over the categories (``return_per_class``:
    each category's, shape ``(1, C)`` or ``(1, C, 3)``)."""
    return _pq_pipeline(preds, target, things, stuffs, allow_unknown_preds_category, modified=False,
                        return_sq_and_rq=return_sq_and_rq, return_per_class=return_per_class)


def modified_panoptic_quality(
    preds: Any,
    target: Any,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
) -> Tensor:
    """Modified PQ: the stuff categories take their IoU sums without the 0.5 matching and count one true positive
    a target segment."""
    return _pq_pipeline(preds, target, things, stuffs, allow_unknown_preds_category, modified=True,
                        return_sq_and_rq=False, return_per_class=False)
