"""Greedy COCO detection <-> ground-truth matching over a padded batch.

Counterpart of ``torchmetrics_tpu/functional/detection/matcher.py``. The
scan over detections in score order carries a per-gt "already matched" mask;
IoU thresholds, area ranges and items are independent. The JAX package
lowers it through XLA as a ``lax.scan`` under three ``vmap``s; the port
runs it as one hand-written CUDA kernel on the card
(``kernels/coco_match.py``, ``csrc/coco_match.cu``) and as
:func:`_match_batch_plain`, a loop over the detections, on the CPU.

Semantics, as in the JAX function and the numpy oracle ``_evaluate_image``:

* eligible: IoU >= min(t, 1 - 1e-10) in float32 (so 1.0 at t = 1.0), and the
  gt is unmatched or crowd;
* non-ignored gts take priority over ignored ones;
* among equal IoUs the LAST gt index wins (pycocotools' scan direction);
* a detection matched to an ignored gt is itself ignored.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.detection.matcher import match_batch
    >>> ious = torch.tensor([[[0.9, 0.6], [0.8, 0.7]]])  # one item: 2 dets x 2 gts
    >>> no = torch.zeros((1, 2), dtype=torch.bool)
    >>> yes = torch.ones((1, 2), dtype=torch.bool)
    >>> matched, det_ignored = match_batch(ious, no, no[:, None], yes, yes, torch.tensor([0.5, 0.85]))
    >>> matched[0, 0].tolist()  # per threshold: which dets matched
    [[True, True], [True, False]]
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels.coco_match import coco_match


def _match_batch_plain(
    ious: Tensor, crowd: Tensor, ignored: Tensor, valid_d: Tensor, valid_g: Tensor, iou_thrs: Tensor
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch matcher: the JAX scan as a loop over D, batched over
    (items, area ranges, thresholds). ``(matched, det_ignored)``, ``(B, A, T, D)`` bool."""
    n_items, n_dets, n_gts = ious.shape
    n_areas, n_thr = ignored.shape[1], iou_thrs.shape[0]
    # jnp.minimum(thr, 1.0 - 1e-10): the constant is 1.0 in float32, and a NaN threshold stays NaN
    thr_eff = torch.minimum(iou_thrs, torch.tensor(1.0 - 1e-10, dtype=torch.float32, device=iou_thrs.device))
    thr_eff = thr_eff[None, None, :, None]
    ign = ignored[:, :, None, :]  # (B, A, 1, G)
    crd = crowd[:, None, None, :]
    vg = valid_g[:, None, None, :]
    gidx = torch.arange(n_gts, device=ious.device)
    gt_matched = torch.zeros((n_items, n_areas, n_thr, n_gts), dtype=torch.bool, device=ious.device)
    matched = torch.zeros((n_items, n_areas, n_thr, n_dets), dtype=torch.bool, device=ious.device)
    det_ignored = torch.zeros_like(matched)
    for d in range(n_dets):
        row = ious[:, d][:, None, None, :]  # (B, 1, 1, G)
        elig = (row >= thr_eff) & (~gt_matched | crd) & vg
        non_ig = elig & ~ign
        pool = torch.where(non_ig.any(-1, keepdim=True), non_ig, elig & ign)
        vals = torch.where(pool, row, -torch.inf)
        m = (n_gts - 1) - torch.argmax(torch.flip(vals, (-1,)), dim=-1)  # last max wins
        has = pool.any(-1) & valid_d[:, d][:, None, None]
        gt_matched |= (gidx == m[..., None]) & has[..., None]
        matched[..., d] = has
        det_ignored[..., d] = has & torch.gather(ign.expand_as(pool), -1, m[..., None])[..., 0]
    return matched, det_ignored


def match_batch(
    ious: Tensor, crowd: Tensor, ignored: Tensor, valid_d: Tensor, valid_g: Tensor, iou_thrs: Tensor
) -> Tuple[Tensor, Tensor]:
    """``(matched (B, A, T, D), det_ignored (B, A, T, D))``, bool.

    Args: ``ious (B, D, G)`` float32 padded, dets sorted by -score per item;
    ``crowd (B, G)``, ``ignored (B, A, G)`` (per-area gt ignore masks),
    ``valid_d (B, D)``, ``valid_g (B, G)`` bool; ``iou_thrs (T,)`` float32.
    On a CUDA tensor, one launch of the ``coco_match`` kernel, which raises
    if it cannot launch; on a CPU tensor, the plain version.
    """
    if ious.device.type == "cpu":
        return _match_batch_plain(ious, crowd, ignored, valid_d, valid_g, iou_thrs)
    return coco_match(ious, crowd, ignored, valid_d, valid_g, iou_thrs)


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


_CHUNK = 1024  # items per launch; bounds the padded buffer


def padded_chunks(items: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]], iou_thrs, device) -> Iterator:
    """``(chunk, args)`` for each chunk of ``_CHUNK`` host items: the items and
    :func:`match_batch`'s arguments on ``device``, padded to power-of-two
    buckets of D and G shared by all items and of the chunk's item count, as
    in the JAX package."""
    if not items:
        return
    n_dets = _bucket(max(i[0].shape[0] for i in items))
    n_gts = _bucket(max(i[0].shape[1] for i in items))
    n_areas = items[0][2].shape[0]
    thrs = torch.as_tensor(np.asarray(iou_thrs, np.float32), device=device)
    for lo in range(0, len(items), _CHUNK):
        chunk = items[lo : lo + _CHUNK]
        n_items = _bucket(len(chunk))
        ious = np.zeros((n_items, n_dets, n_gts), np.float32)
        crowd = np.zeros((n_items, n_gts), bool)
        ignored = np.zeros((n_items, n_areas, n_gts), bool)
        valid_d = np.zeros((n_items, n_dets), bool)
        valid_g = np.zeros((n_items, n_gts), bool)
        for b, (iou, cr, ig) in enumerate(chunk):
            d, g = iou.shape
            ious[b, :d, :g] = iou
            crowd[b, :g] = cr
            ignored[b, :, :g] = ig
            valid_d[b, :d] = True
            valid_g[b, :g] = True
        yield chunk, tuple(torch.from_numpy(a).to(device) for a in (ious, crowd, ignored, valid_d, valid_g)) + (thrs,)


def match_batch_padded(items: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]], iou_thrs, device) -> List:
    """Match host items ``(ious (D, G), crowd (G,), ignored (A, G))`` on ``device``,
    one :func:`match_batch` call a chunk of :func:`padded_chunks`; returns per
    item ``(matched (A, T, D_i), det_ignored (A, T, D_i))`` numpy bool arrays,
    unpadded."""
    out = []
    for chunk, args in padded_chunks(items, iou_thrs, device):
        m, di = match_batch(*args)
        m, di = m.cpu().numpy(), di.cpu().numpy()
        out.extend((m[b, :, :, : it[0].shape[0]], di[b, :, :, : it[0].shape[0]]) for b, it in enumerate(chunk))
    return out
