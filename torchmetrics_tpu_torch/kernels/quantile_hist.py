"""Launcher of the ``quantile_hist`` CUDA kernel (``csrc/quantile_hist.cu``) and its plain version.

:func:`quantile_hist` folds one formatted batch of curve scores into the
float32 ``(K, 2, bins + 1)`` (negative, positive) histogram pair of the curve
family's ``approx="sketch"`` state, in place, in one launch: each entry's
weight goes into cell ``(k, target == class, cell(score))`` without a one-hot
or an ``(N, K, 2)`` temporary. It counts its launches in
``quantile_hist.launches`` and takes CUDA tensors only.

:func:`_quantile_hist_plain` is the JAX package's form in plain PyTorch
(``_CurveBase._sketch_insert``: the one-hot, the broadcast, the stack and
``QuantileSketch.insert_batch``'s ``index_add``), out of place. The dispatch
by device is ``classification.precision_recall_curve._sketch_accumulate``.

The weights must be 0 or 1 (an entry of weight 0 is skipped, any other counts
once): the curve formats make them so. Counts are integers, so the state is
exact, and the same from launch to launch, while a cell stays below 2**24, the
bound of JAX's float32 histogram.

:func:`plan` is the launch geometry, kept in Python so that the CPU tests
reach it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import cdiv, check_tensor, launch_on, load_library, sm_count
from torchmetrics_tpu_torch.sketches.quantile import QuantileSketch
from torchmetrics_tpu_torch.utilities.data import one_hot

SOURCE = "quantile_hist"
THREADS = 256  # kThreads
UNROLL = 8  # kUnroll: entries a thread loads before it counts any
SHARED_BYTES = 48 * 1024  # kSharedBytes: a block's (slice, 2, cells) int32 counts in shared memory up to here
BLOCKS_PER_SM = 2
MIN_ROWS_PER_CELL = 4  # rows a chunk at least 4 x cells: zeroing and flushing the counts cost at most a fourth
MAX_CHUNKS = 65_535  # row chunks along grid.y
MAX_ENTRIES = 2**30  # (row, class) entries a block: the kernel's int32 entry index never overflows

_launch: Optional[ctypes._CFuncPtr] = None


class Plan(NamedTuple):
    slice: int  # classes a block (grid.x = ceil(K / slice))
    rows_per_chunk: int
    chunks: int  # grid.y
    shared: bool  # counts in shared memory; else float atomics straight into the state


@functools.lru_cache(maxsize=256)
def plan(n_rows: int, k: int, cells: int, sm_count: int) -> Plan:
    """About ``BLOCKS_PER_SM`` blocks an SM: few classes a block where there are many classes, chunks of rows
    where there are few, no chunk shorter than ``MIN_ROWS_PER_CELL`` x cells."""
    target = BLOCKS_PER_SM * sm_count
    shared = 2 * cells * 4 <= SHARED_BYTES
    max_slice = SHARED_BYTES // (8 * cells) if shared else k
    slice_ = max(1, min(k, max_slice, cdiv(k, target)))
    slices = cdiv(k, slice_)
    chunks = max(1, min(cdiv(target, slices), n_rows // (MIN_ROWS_PER_CELL * cells), MAX_CHUNKS))
    chunks = min(max(chunks, cdiv(n_rows * slice_, MAX_ENTRIES)), MAX_CHUNKS)
    rows = cdiv(n_rows, chunks)
    return Plan(slice_, rows, cdiv(n_rows, rows), shared)


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).quantile_hist_launch
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [p, p, p, p, ll, i, i, f, f, i, i, ll, i, i, p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _quantile_hist_plain(hist: Tensor, scores: Tensor, target: Tensor, weights: Tensor,
                         sketch: QuantileSketch) -> Tensor:
    """Plain PyTorch :func:`quantile_hist`, JAX's ``_sketch_insert``: a new histogram, ``hist`` left as it is.

    ``scores`` ``(N,)`` with ``hist`` ``(2, cells)``, or ``(N, K)`` with ``hist``
    ``(K, 2, cells)``; a ``(N,)`` ``target`` beside ``(N, K)`` scores is a class
    index (the multiclass task), otherwise a 0/1 target of the scores' shape.
    """
    t, w = target, weights
    if scores.ndim == 2 and t.ndim == 1:  # multiclass scores and an integer target
        t = one_hot(t, scores.shape[1], scores.dtype)
        w = w[:, None]
    pos = t.to(scores.dtype) * w
    neg = w - pos
    values = scores[..., None].expand(*scores.shape, 2)
    return sketch.insert_batch(hist, values, torch.stack([neg, pos], dim=-1))


def quantile_hist(hist: Tensor, scores: Tensor, target: Tensor, weights: Tensor, sketch: QuantileSketch) -> Tensor:
    """Add one batch into the curve histogram pair ``hist`` in place, by the CUDA kernel; returns ``hist``.

    ``chip_smoke.py`` holds it against :func:`_quantile_hist_plain` on the
    card: equal bit for bit.

    Args:
        hist: float32 ``(2, bins + 1)`` (binary) or ``(K, 2, bins + 1)``,
            contiguous, on a CUDA device.
        scores: float32 ``(N,)`` (binary) or ``(N, K)``, contiguous.
        target: int32; ``(N,)`` class indices beside ``(N, K)`` scores
            (multiclass: a target outside ``[0, K)`` is a negative for every
            class), else a target of the scores' shape (``t`` adds ``1 - t`` to
            the negative cell and ``t`` to the positive one: 0/1 targets add 1
            to one of them).
        weights: float32, the target's shape, each 0 or 1.
        sketch: the grid (``bins``, ``lo``, ``hi``).

    Every check raises ``ValueError`` before anything is built or launched; a
    CUDA error of the launch raises ``RuntimeError``. An empty batch launches
    nothing.
    """
    device = hist.device
    multiclass = scores.ndim == 2 and target.ndim == 1
    n = scores.shape[0]
    k = scores.shape[1] if scores.ndim == 2 else 1
    cells = sketch.bins + 1
    if scores.ndim not in (1, 2):
        raise ValueError(f"quantile_hist takes (N,) or (N, K) scores, got {tuple(scores.shape)}")
    want_hist = (2, cells) if scores.ndim == 1 else (k, 2, cells)
    check_tensor("quantile_hist", "hist", hist, torch.float32, want_hist, device)
    check_tensor("quantile_hist", "scores", scores, torch.float32, tuple(scores.shape), device)
    side = (n,) if multiclass else tuple(scores.shape)
    check_tensor("quantile_hist", "target", target, torch.int32, side, device)
    check_tensor("quantile_hist", "weights", weights, torch.float32, side, device)
    if device.type != "cuda":
        raise ValueError(f"quantile_hist takes CUDA tensors, got {device}")
    if n == 0:
        return hist
    pl = plan(n, k, cells, sm_count(device))
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (scores.data_ptr(), target.data_ptr(), weights.data_ptr(), hist.data_ptr(), n, k, sketch.bins,
            float(sketch.lo), float(sketch.scale), int(multiclass), pl.slice, pl.rows_per_chunk, pl.chunks,
            int(pl.shared), stream)
    launch_on("quantile_hist", device, _launch_fn(), args)
    quantile_hist.launches += 1
    return hist


quantile_hist.launches = 0
