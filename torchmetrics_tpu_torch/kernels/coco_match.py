"""Launcher of the ``coco_match`` CUDA kernel (``csrc/coco_match.cu``).

:func:`coco_match` is the greedy COCO matcher of a padded batch of
(class, image) items: it checks its inputs, chooses the launch plan
(:func:`launch_plan`: a block per item, a group of lanes per area range and
IoU threshold), launches one kernel on the current stream and counts its
launches in ``coco_match.launches`` and, by ``(B, D, G, A, T)``, in
``coco_match.shapes``. It takes CUDA tensors only: the dispatch between the
kernel and its plain PyTorch version, by the device of the input, is
``functional.detection.matcher.match_batch``.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import launch_on, load_library

SOURCE = "coco_match"
MAX_GTS = 256  # ground truths of one item: 8 a lane of a warp
MAX_THRESHOLDS = 32  # as the earlier kernel took; the launch plan would split more over blocks
MAX_THREADS = 256  # kMaxThreads in the source: the threads of one block
STAGE_BYTES = 96 * 1024  # kStageBytes in the source: the largest (D, G) float tile staged in shared memory
MAX_SHARED_BYTES = 227 * 1024  # dynamic shared memory one block may use on Hopper

_launch: Optional[ctypes._CFuncPtr] = None


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).coco_match_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def lane_group(n_gts: int) -> Tuple[int, int]:
    """``(P, KPL)``: the lanes that carry one scan and the ground truths each lane holds.

    For G <= 32, ``P = max(8, next_pow2(G))`` lanes, one ground truth a lane
    (mAP pads G to a multiple of 8, so narrower groups would serve no caller);
    above, a whole warp with ``ceil(G / 32)`` rounded up to 2, 4 or 8 a lane.
    """
    if n_gts <= 32:
        return max(8, 1 << (n_gts - 1).bit_length()), 1
    need = -(-n_gts // 32)
    return 32, next(k for k in (2, 4, 8) if k >= need)


def shared_bytes(n_dets: int, n_gts: int, n_areas: int, staged: bool) -> int:
    """Dynamic shared memory of one block, in the order the kernel lays it out:
    the staged (D, G) IoU tile, the ground truths' crowd, valid and per-area
    ignored bit masks, the ``valid_d`` bytes. The launch passes it to the
    kernel as its size."""
    return (n_dets * n_gts * 4 if staged else 0) + 4 * (2 + n_areas) * (-(-n_gts // 32)) + n_dets


class LaunchPlan(NamedTuple):
    lanes: int  # P: lanes a scan
    gts_per_lane: int  # KPL
    scans_per_block: int  # of the A*T (area range, threshold) scans of one item
    blocks_per_item: int
    threads: int
    staged: bool  # the (D, G) tile in shared memory, else read from device memory
    shared_bytes: int


def launch_plan(n_dets: int, n_gts: int, n_areas: int, n_thr: int) -> LaunchPlan:
    """The plan of one launch: one block per item when its ``A*T`` scans fit in
    ``MAX_THREADS`` threads, else the fewest blocks per item that hold them,
    the scans shared evenly."""
    lanes, kpl = lane_group(n_gts)
    n_scans = n_areas * n_thr
    staged = n_dets * n_gts * 4 <= STAGE_BYTES
    blocks = -(-n_scans * lanes // MAX_THREADS)  # the fewest that hold the item's scans
    spb = -(-n_scans // blocks)
    smem = shared_bytes(n_dets, n_gts, n_areas, staged)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"coco_match: D={n_dets} detections need {smem} bytes of shared memory a block, "
                         f"more than {MAX_SHARED_BYTES}")
    threads = -(-spb * lanes // 32) * 32
    return LaunchPlan(lanes, kpl, spb, -(-n_scans // spb), threads, staged, smem)


def _check(name: str, x: Tensor, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    if x.dtype != dtype:
        raise ValueError(f"coco_match: `{name}` has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"coco_match: `{name}` has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"coco_match: `{name}` must be contiguous")
    if x.device != device:
        raise ValueError(f"coco_match: `{name}` is on {x.device}, expected {device}")


def coco_match(
    ious: Tensor, crowd: Tensor, ignored: Tensor, valid_d: Tensor, valid_g: Tensor, iou_thrs: Tensor
) -> Tuple[Tensor, Tensor]:
    """``(matched, det_ignored)``, ``(B, A, T, D)`` bool each, by the CUDA kernel.

    ``chip_smoke.py`` holds both equal (``torch.equal``) to
    ``functional.detection.matcher._match_batch_plain`` on the card.

    Args:
        ious: ``(B, D, G)`` float32, detections of each item in score order.
        crowd: ``(B, G)`` bool.
        ignored: ``(B, A, G)`` bool, each area range's ground-truth ignore flags.
        valid_d: ``(B, D)`` bool, real (not padded) detections.
        valid_g: ``(B, G)`` bool, real ground truths.
        iou_thrs: ``(T,)`` float32.

    Every check raises ``ValueError`` before anything is built or launched;
    a CUDA error of the launch raises ``RuntimeError``.
    """
    if ious.ndim != 3 or ignored.ndim != 3 or iou_thrs.ndim != 1:
        raise ValueError("coco_match takes ious (B, D, G), ignored (B, A, G) and iou_thrs (T,)")
    n_items, n_dets, n_gts = ious.shape
    n_areas, n_thr = ignored.shape[1], iou_thrs.shape[0]
    if not (1 <= n_gts <= MAX_GTS and 1 <= n_thr <= MAX_THRESHOLDS and n_dets >= 1 and n_areas >= 1):
        raise ValueError(
            f"coco_match takes 1 to {MAX_GTS} ground truths, 1 to {MAX_THRESHOLDS} thresholds and at least "
            f"one detection and area range an item, got G={n_gts}, T={n_thr}, D={n_dets}, A={n_areas}"
        )
    device = ious.device
    _check("ious", ious, torch.float32, (n_items, n_dets, n_gts), device)
    _check("crowd", crowd, torch.bool, (n_items, n_gts), device)
    _check("ignored", ignored, torch.bool, (n_items, n_areas, n_gts), device)
    _check("valid_d", valid_d, torch.bool, (n_items, n_dets), device)
    _check("valid_g", valid_g, torch.bool, (n_items, n_gts), device)
    _check("iou_thrs", iou_thrs, torch.float32, (n_thr,), device)
    plan = launch_plan(n_dets, n_gts, n_areas, n_thr)
    if n_items * plan.blocks_per_item >= 2**31 or n_items * n_dets * n_gts >= 2**31:
        raise ValueError("coco_match: the batch is too large for one launch")
    if device.type != "cuda":
        raise ValueError(f"coco_match runs on CUDA tensors only, got them on {device}")

    matched = torch.empty((n_items, n_areas, n_thr, n_dets), dtype=torch.uint8, device=device)
    det_ignored = torch.empty_like(matched)
    if n_items == 0:
        return matched.view(torch.bool), det_ignored.view(torch.bool)
    args = (
        ious.data_ptr(), crowd.data_ptr(), ignored.data_ptr(), valid_d.data_ptr(), valid_g.data_ptr(),
        iou_thrs.data_ptr(), matched.data_ptr(), det_ignored.data_ptr(), n_items, n_dets, n_gts, n_areas, n_thr,
        plan.lanes, plan.gts_per_lane, plan.scans_per_block, int(plan.staged), plan.shared_bytes,
        torch.cuda.current_stream(device).cuda_stream,
    )
    launch_on("coco_match", device, _launch_fn(), args)
    coco_match.launches += 1
    coco_match.shapes[(n_items, n_dets, n_gts, n_areas, n_thr)] += 1
    return matched.view(torch.bool), det_ignored.view(torch.bool)


coco_match.launches = 0
coco_match.shapes = collections.Counter()
