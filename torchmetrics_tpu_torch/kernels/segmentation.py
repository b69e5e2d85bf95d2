"""Launcher of the ``segmentation_counts`` CUDA kernel (``csrc/segmentation.cu``) and its plain version.

:func:`segmentation_counts` gives, for two label maps ``(N, *S)``, every
image's per-class intersection, prediction count and target count as one
``(N, 3, C)`` int32 tensor, in one launch: the labels are read once and never
expanded to one-hots. It counts its launches in
``segmentation_counts.launches`` and takes CUDA tensors only.
:func:`_segmentation_counts_plain` is the JAX package's form in plain
PyTorch: both maps as ``(N, C, *S)`` one-hots, then three spatial sums. The
dispatch by device is ``functional.segmentation.mean_iou._index_counts``.

The index rule is ``jnp.eye(C)[idx]``'s: an int64 label counts as its low 32
bits, a negative index wraps once, then the index is clamped to ``[0, C-1]``
(a void 255 at C = 19 counts as class 18).

:func:`plan` is the launch geometry, kept in Python so that the CPU tests
reach it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import cdiv, launch_on, load_library, sm_count

SOURCE = "segmentation"
THREADS = 256  # kThreads
SHARED_CLASSES = 4096  # kSharedClasses: a block's 3 x C histogram in 48 KB of shared memory up to here
CHUNK_ALIGN = 16  # a chunk is a whole number of 16-byte loads of uint8 labels (and of int32, int64)
MIN_CHUNK = 4096  # pixels a block at least: its histogram's zeroing and flush are paid once a chunk
BLOCKS_PER_SM = 8
MAX_IMAGES = 65_535  # images along grid.y
MAX_PIXELS = 2**31 - 1  # pixels an image: the counts are int32
MAX_CLASSES = 2**28  # 3 * C int32 cells an image stay far inside int32 indexing

# the codes of csrc/segmentation.cu
KINDS = {torch.uint8: 0, torch.int32: 1, torch.int64: 2}

_launch: Optional[ctypes._CFuncPtr] = None


class Plan(NamedTuple):
    chunk: int  # pixels a block, a multiple of CHUNK_ALIGN
    chunks: int  # blocks an image (grid.x)
    shared: bool  # the block's histogram in shared memory; else global atomics on the output


@functools.lru_cache(maxsize=256)
def plan(n_images: int, pixels: int, n_classes: int, sm_count: int) -> Plan:
    """About ``BLOCKS_PER_SM`` blocks an SM over all images, each of at least ``MIN_CHUNK`` pixels."""
    chunks = max(1, min(cdiv(pixels, MIN_CHUNK), cdiv(BLOCKS_PER_SM * sm_count, n_images)))
    chunk = cdiv(cdiv(pixels, chunks), CHUNK_ALIGN) * CHUNK_ALIGN
    return Plan(chunk, cdiv(pixels, chunk), n_classes <= SHARED_CLASSES)


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).segmentation_counts_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, p, i, p, i, ll, i, ll, i, p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _class_index(labels: Tensor, n_classes: int) -> Tensor:
    """``jnp.eye(C)[labels]``'s row: the low 32 bits, one wrap of a negative index, the clamp to ``[0, C-1]``."""
    idx = labels.to(torch.int32).to(torch.int64)
    idx = torch.where(idx < 0, idx + n_classes, idx)
    return idx.clamp(0, n_classes - 1)


def _segmentation_counts_plain(preds: Tensor, target: Tensor, n_classes: int) -> Tensor:
    """Plain PyTorch :func:`segmentation_counts`: JAX's one-hots ``(N, C, *S)`` and three spatial sums."""
    shape = (1, n_classes) + (1,) * (preds.ndim - 1)
    classes = torch.arange(n_classes, device=preds.device).view(shape)
    p_oh = _class_index(preds, n_classes).unsqueeze(1) == classes
    t_oh = _class_index(target, n_classes).unsqueeze(1) == classes
    sums = [p_oh & t_oh, p_oh, t_oh]
    if p_oh.ndim > 2:  # (N, C) one-hots of (N,) maps: a pixel an image, nothing to sum
        sums = [x.sum(tuple(range(2, p_oh.ndim))) for x in sums]
    return torch.stack(sums, 1).to(torch.int32)


def segmentation_counts(preds: Tensor, target: Tensor, n_classes: int) -> Tensor:
    """``(N, 3, C)`` int32: each image's intersection, prediction and target count a class, by the CUDA kernel.

    ``chip_smoke.py`` holds it equal (``torch.equal``) to
    :func:`_segmentation_counts_plain` on the card.

    Args:
        preds, target: uint8, int32 or int64 label maps ``(N, *S)`` of one
            shape, contiguous, on one CUDA device (the two dtypes may differ).
        n_classes: C, from 1 to ``MAX_CLASSES``.

    Every check raises ``ValueError`` before anything is built or launched; a
    CUDA error of the launch raises ``RuntimeError``. An empty batch launches
    nothing.
    """
    for name, x in (("preds", preds), ("target", target)):
        if x.dtype not in KINDS:
            raise ValueError(f"segmentation_counts takes uint8, int32 or int64 `{name}`, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"segmentation_counts: `{name}` must be contiguous")
    if preds.shape != target.shape or preds.ndim < 1:
        raise ValueError(f"segmentation_counts takes (N, *S) preds and target of one shape, got "
                         f"{tuple(preds.shape)} and {tuple(target.shape)}")
    if not 1 <= n_classes <= MAX_CLASSES:
        raise ValueError(f"segmentation_counts takes 1 to {MAX_CLASSES} classes, got {n_classes}")
    n_images, pixels = preds.shape[0], math.prod(preds.shape[1:])
    if n_images > MAX_IMAGES or pixels > MAX_PIXELS:
        raise ValueError(f"segmentation_counts takes at most {MAX_IMAGES} images of fewer than 2**31 pixels, got "
                         f"{n_images} of {pixels}")
    device = preds.device
    if target.device != device:
        raise ValueError(f"segmentation_counts: `target` is on {target.device}, expected {device}")
    if device.type != "cuda":
        raise ValueError(f"segmentation_counts runs on CUDA tensors only, got them on {device}")
    out = torch.zeros((n_images, 3, n_classes), dtype=torch.int32, device=device)
    if n_images == 0 or pixels == 0:
        return out
    g = plan(n_images, pixels, n_classes, sm_count(device))
    args = (preds.data_ptr(), KINDS[preds.dtype], target.data_ptr(), KINDS[target.dtype], out.data_ptr(), n_images,
            pixels, n_classes, g.chunk, g.chunks, torch.cuda.current_stream(device).cuda_stream)
    launch_on("segmentation_counts", device, _launch_fn(), args)
    segmentation_counts.launches += 1
    return out


segmentation_counts.launches = 0
