"""Launcher of the ``mask_iou`` CUDA kernel (``csrc/mask_iou.cu``) and its plain version.

:func:`mask_iou` gives, for each image of a list, the exact int32
intersection counts ``(D, G)`` of its detection masks ``(D, H, W)`` and
ground-truth masks ``(G, H, W)`` (bool) and the masks' areas ``(D,)`` and
``(G,)``, for every image in one launch. It counts its launches in
``mask_iou.launches`` and takes CUDA tensors only. :func:`_mask_iou_plain` is
the JAX package's float64 product in plain PyTorch; :func:`mask_iou_counts`
is the dispatch by device.

:func:`plan` is the launch's list of entries, kept in Python so that the CPU
tests reach it: a cell of detections and ground truths of one image, its
chunk of pixels (whole groups of 512), its first block.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import cdiv, launch_on, load_library, sm_count

SOURCE = "mask_iou"
THREADS = 256  # kThreads
GROUP = 16  # kGroup: words of a group, 512 pixels, 16 a lane
IN_FLIGHT = 4  # kInFlight: groups a warp loads before it ballots them
SHARED_WORDS = 12_032  # kSharedWords: a block's packed bits
MAX_MASKS = 256  # kMaxMasks: detections and ground truths of an entry together
MAX_WORDS = 1_024  # kMaxWords: words of a mask in a chunk
MAX_INT32 = 2**31 - 1
ENTRY_FIELDS = 12  # the int64 fields of csrc/mask_iou.cu's Entry

Counts = Tuple[Tensor, Tensor, Tensor]  # (inter (D, G), det_area (D,), gt_area (G,)), int32

_launch: Optional[ctypes._CFuncPtr] = None


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).mask_iou_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


class Entry(NamedTuple):
    image: int
    d0: int  # the entry's detections d0 .. d0 + n_det - 1 of the image
    n_det: int
    g0: int  # and ground truths g0 .. g0 + n_gt - 1
    n_gt: int
    words: int  # words of a mask a chunk
    chunks: int  # blocks of the entry
    first_block: int


def chunk_words(n_masks: int) -> int:
    """Words of a mask a block packs: whole groups of 16, as many as fit ``n_masks`` rows of an odd stride
    (``words + 1``) in the shared bits, at most ``MAX_WORDS``."""
    return min(MAX_WORDS, GROUP * ((SHARED_WORDS // n_masks - 1) // GROUP))


def plan(shapes: Sequence[Tuple[int, int, int]], min_blocks: int = 0) -> List[Entry]:
    """The entries of a launch over images of ``(D, G, H * W)``: an image with a detection and a ground truth
    is cut into blocks of detections and ground truths of at most ``MAX_MASKS`` masks together (all of it,
    mostly), each entry a grid of chunks of pixels. Images with ``D = 0`` or ``G = 0`` take no entry. While the
    grid has fewer than ``min_blocks`` blocks, every chunk loses a group (down to one)."""
    cells = []
    for image, (n_d, n_g, hw) in enumerate(shapes):
        if n_d == 0 or n_g == 0 or hw == 0:
            continue
        g_step = n_g if n_d + n_g <= MAX_MASKS else min(n_g, MAX_MASKS // 2)
        d_step = min(n_d, MAX_MASKS - g_step)
        for d0 in range(0, n_d, d_step):
            for g0 in range(0, n_g, g_step):
                n_det, n_gt = min(d_step, n_d - d0), min(g_step, n_g - g0)
                cells.append([image, d0, n_det, g0, n_gt, chunk_words(n_det + n_gt), hw])
    while cells:
        total = sum(cdiv(hw, words * 32) for *_, words, hw in cells)
        if total >= min_blocks or all(c[5] == GROUP for c in cells):
            break
        for c in cells:
            c[5] = max(GROUP, c[5] - GROUP)
    entries, first = [], 0
    for image, d0, n_det, g0, n_gt, words, hw in cells:
        chunks = cdiv(hw, words * 32)
        entries.append(Entry(image, d0, n_det, g0, n_gt, words, chunks, first))
        first += chunks
    return entries


def _check(det_masks: Sequence[Tensor], gt_masks: Sequence[Tensor]) -> None:
    if len(det_masks) != len(gt_masks):
        raise ValueError(f"mask_iou takes as many detection as ground-truth mask sets, got {len(det_masks)} and "
                         f"{len(gt_masks)}")
    for i, (d, g) in enumerate(zip(det_masks, gt_masks)):
        if d.dtype != torch.bool or g.dtype != torch.bool:
            raise ValueError(f"mask_iou takes bool masks, got {d.dtype} and {g.dtype} (image {i})")
        if d.ndim != 3 or g.ndim != 3 or (d.shape[0] and g.shape[0] and d.shape[1:] != g.shape[1:]):
            raise ValueError(f"mask_iou takes masks (D, H, W) and (G, H, W), got {tuple(d.shape)} and "
                             f"{tuple(g.shape)} (image {i})")
        if d.shape[1] * d.shape[2] > MAX_INT32 or max(d.shape[0], g.shape[0]) > MAX_INT32:
            raise ValueError(f"mask_iou counts in int32: H * W up to 2**31 - 1, got {tuple(d.shape)} (image {i})")


def _areas(masks: Tensor) -> Tensor:
    return masks.flatten(1).sum(1, dtype=torch.int32)


def _mask_iou_plain(det_masks: Sequence[Tensor], gt_masks: Sequence[Tensor]) -> List[Counts]:
    """Plain PyTorch :func:`mask_iou`: the JAX package's float64 ``d @ g.T`` and row sums, as int32."""
    _check(det_masks, gt_masks)
    out = []
    for d, g in zip(det_masks, gt_masks):
        if d.shape[0] == 0 or g.shape[0] == 0:
            out.append((torch.zeros((d.shape[0], g.shape[0]), dtype=torch.int32, device=d.device), _areas(d),
                        _areas(g)))
            continue
        df, gf = d.flatten(1).to(torch.float64), g.flatten(1).to(torch.float64)
        out.append(((df @ gf.T).to(torch.int32), df.sum(1).to(torch.int32), gf.sum(1).to(torch.int32)))
    return out


def mask_iou(det_masks: Sequence[Tensor], gt_masks: Sequence[Tensor]) -> List[Counts]:
    """Each image's ``(inter (D, G), det_area (D,), gt_area (G,))`` int32 counts, by the CUDA kernel.

    ``chip_smoke.py`` holds it equal (``torch.equal``) to :func:`_mask_iou_plain` on the card.

    Args:
        det_masks, gt_masks: a bool ``(D_i, H_i, W_i)`` and ``(G_i, H_i, W_i)`` tensor an image, on one CUDA
            device; ``H_i W_i`` up to 2**31 - 1 (an empty set's ``H, W`` need not be the other's).

    One launch covers every image with a detection and a ground truth; an image with ``D = 0`` or ``G = 0``
    takes its zero counts and its areas (row sums) without one, and a list of such images launches nothing.
    Every check raises ``ValueError`` before anything is built or launched; a CUDA error of the launch raises
    ``RuntimeError``.
    """
    _check(det_masks, gt_masks)
    if not det_masks:
        return []
    device = det_masks[0].device
    if device.type != "cuda" or any(x.device != device for x in (*det_masks, *gt_masks)):
        raise ValueError(f"mask_iou runs on CUDA tensors of one device, got them on {device}")
    det_masks = [d.contiguous() for d in det_masks]
    gt_masks = [g.contiguous() for g in gt_masks]
    shapes = [(d.shape[0], g.shape[0], d.shape[1] * d.shape[2]) for d, g in zip(det_masks, gt_masks)]
    sizes = [n_d * n_g + n_d + n_g for n_d, n_g, _ in shapes]
    buffer = torch.zeros(sum(sizes), dtype=torch.int32, device=device)
    views, start = [], 0
    for (n_d, n_g, _), size in zip(shapes, sizes):
        inter = buffer[start:start + n_d * n_g].view(n_d, n_g)
        det_area = buffer[start + n_d * n_g:start + n_d * n_g + n_d]
        gt_area = buffer[start + n_d * n_g + n_d:start + size]
        views.append((inter, det_area, gt_area))
        start += size
    entries = plan(shapes, min_blocks=2 * sm_count(device))
    if entries:
        table = []
        for e in entries:
            inter, det_area, gt_area = views[e.image]
            hw = shapes[e.image][2]
            table.append([
                det_masks[e.image].data_ptr() + e.d0 * hw, gt_masks[e.image].data_ptr() + e.g0 * hw,
                inter.data_ptr() + 4 * (e.d0 * shapes[e.image][1] + e.g0),
                det_area.data_ptr() + 4 * e.d0 if e.g0 == 0 else 0,
                gt_area.data_ptr() + 4 * e.g0 if e.d0 == 0 else 0,
                e.n_det, e.n_gt, hw, shapes[e.image][1], e.words, e.first_block, 0,
            ])
        blocks = entries[-1].first_block + entries[-1].chunks
        # from pinned memory, so that the copy is queued on the stream and the host does not wait for the card
        table_t = torch.tensor(table, dtype=torch.int64).pin_memory().to(device, non_blocking=True)
        launch_on("mask_iou", device, _launch_fn(),
                  (table_t.data_ptr(), len(entries), blocks, torch.cuda.current_stream(device).cuda_stream))
        mask_iou.launches += 1
    for i, (n_d, n_g, _) in enumerate(shapes):
        if n_d == 0 or n_g == 0:
            views[i][1].copy_(_areas(det_masks[i]))
            views[i][2].copy_(_areas(gt_masks[i]))
    return views


mask_iou.launches = 0


def mask_iou_counts(det_masks: Sequence[Tensor], gt_masks: Sequence[Tensor]) -> List[Counts]:
    """The masks' counts: the CUDA kernel for masks on the card, its plain version on the CPU."""
    if det_masks and det_masks[0].device.type == "cuda":
        return mask_iou(det_masks, gt_masks)
    return _mask_iou_plain(det_masks, gt_masks)
