"""Launchers of the binned-curve CUDA kernels (``csrc/binned_confmat.cu``).

:func:`binned_confmat_multiclass` and :func:`binned_confmat_multilabel` are
the fused binned-curve state updates, one-vs-rest over classes and per label:
each checks its inputs, enqueues the whole update (a memset of its scratch,
the histogram kernel and the epilogue kernel) on the current stream with
one call into the library, and counts its calls in its ``launches``
attribute. They take CUDA tensors only: the dispatch between a kernel and
its plain PyTorch version, by the device of the input, is
``functional.classification.precision_recall_curve._binned_confmat_multiclass_accumulate``
and ``_binned_confmat_multilabel_accumulate`` (the binary update at one label).

:func:`plan` is the launch geometry, kept in Python so that the CPU tests
reach it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import load_library

SOURCE = "binned_confmat"
THREADS = 256  # kThreads in the source
EPI_WARPS = 8  # kEpiWarps in the source: an epilogue block covers 32 classes x EPI_WARPS warps of bins
CLASS_TILES = (128, 64, 32)  # classes a histogram block covers, widest first; 4 per thread
HIST_BUDGET = 96 * 1024  # bytes of shared histogram a block may hold: two blocks fit on an SM
MAX_THRESHOLDS = 16384  # the sorted thresholds sit in shared memory beside the bins
MAX_ROWS = 2**31 - 1  # int32 counts and row indices
_BLOCKS_PER_SM = 2
_EPI_BLOCKS_PER_SM = 4  # epilogue blocks are 8 warps; its tail costs one load a segment above

_sm_count: Dict[int, int] = {}
_launch: Dict[str, ctypes._CFuncPtr] = {}


class Plan(NamedTuple):
    tile_c: int  # classes of a histogram block
    bins_per_range: int  # histogram bins of a block; T+1 bins need ceil((T+1) / bins_per_range) ranges
    rows_per_block: int
    grid: tuple  # the histogram kernel's (class tiles, row chunks, bin ranges)
    bins_per_warp: int  # epilogue: bins of one warp
    epilogue_grid: tuple  # (32-class tiles, bin segments)


@functools.lru_cache(maxsize=256)
def plan(n_rows: int, n_classes: int, n_thr: int, sm_count: int, one_wave: bool = False) -> Plan:
    """The launch geometry for an ``(n_rows, n_classes)`` batch and ``n_thr`` thresholds.

    Histogram kernel: the widest class tile whose ``T+1`` bins fit the shared
    budget; where even 32 classes cannot hold them, the bins split into
    balanced ranges. Rows are cut into chunks until the grid has
    ``_BLOCKS_PER_SM`` blocks per SM, the chunk's rows rounded down (at
    least that many blocks); with ``one_wave`` rounded up (at most that many,
    one wave of blocks: at 1,024 rows of one label, 256 blocks of 4 rows and
    not 342 of 3). Epilogue: bins are cut into segments of
    ``EPI_WARPS * bins_per_warp`` until its grid has as many blocks, or each
    warp holds one bin.
    """
    n_bins = n_thr + 1
    slot_words = 0
    for tile_c in CLASS_TILES:
        slot_words = HIST_BUDGET // (4 * tile_c)  # int32 words of one class's bins
        if n_bins | 1 <= slot_words:  # the source pads a class's bins to an odd count
            break
    ranges = _cdiv(n_bins, slot_words - 1)
    per_range = _cdiv(n_bins, ranges)  # balanced ranges
    class_tiles = _cdiv(n_classes, tile_c)
    chunks = max(1, _cdiv(_BLOCKS_PER_SM * sm_count, class_tiles * ranges))
    rows = max(n_rows, 1)
    rows_per_block = _cdiv(rows, chunks) if one_wave else max(1, rows // chunks)
    epi_tiles = _cdiv(n_classes, 32)
    segments = max(1, _cdiv(_EPI_BLOCKS_PER_SM * sm_count, epi_tiles))
    bins_per_warp = max(1, n_bins // (EPI_WARPS * segments))  # rounded down: at least `segments` segments
    return Plan(
        tile_c, per_range, rows_per_block, (class_tiles, _cdiv(rows, rows_per_block), ranges),
        bins_per_warp, (epi_tiles, _cdiv(n_bins, EPI_WARPS * bins_per_warp)),
    )


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _launch_fn(name: str) -> ctypes._CFuncPtr:
    if name not in _launch:
        fn = getattr(load_library(SOURCE), f"{name}_launch")
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch[name] = fn
    return _launch[name]


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_count[index]


def _check(kernel: str, name: str, x: Tensor, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    if x.dtype != dtype:
        raise ValueError(f"{kernel}: `{name}` has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{kernel}: `{name}` has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: `{name}` must be contiguous")
    if x.device != device:
        raise ValueError(f"{kernel}: `{name}` is on {x.device}, expected {device}")


def _update(
    kernel: str, confmat: Tensor, probs: Tensor, target: Tensor, weights: Tensor, sorted_thresholds: Tensor,
    order: Tensor, row_shape: tuple,
) -> Tensor:
    """Check the inputs of ``kernel``'s update, launch it and return the new state.

    ``row_shape`` is the shape of the target and the weights after the row
    count: ``()`` for the multiclass kernel, ``(L,)`` for the multilabel one,
    whose plan keeps to one wave of blocks.
    """
    if probs.ndim != 2:
        raise ValueError(f"{kernel}: `probs` has {probs.ndim} dims, expected 2")
    n_rows, n_cols = probs.shape
    n_thr = sorted_thresholds.shape[0] if sorted_thresholds.ndim == 1 else -1
    if n_cols < 1 or not 1 <= n_thr <= MAX_THRESHOLDS:
        raise ValueError(
            f"{kernel} needs at least one column and 1 to {MAX_THRESHOLDS} thresholds "
            f"in one dimension, got {n_cols} columns and thresholds of shape {tuple(sorted_thresholds.shape)}"
        )
    if n_rows > MAX_ROWS:
        raise ValueError(f"{kernel} takes fewer than 2**31 rows a launch, got {n_rows}")
    device = probs.device
    _check(kernel, "probs", probs, torch.float32, (n_rows, n_cols), device)
    _check(kernel, "target", target, torch.int32, (n_rows, *row_shape), device)
    _check(kernel, "weights", weights, torch.float32, (n_rows, *row_shape), device)
    _check(kernel, "sorted_thresholds", sorted_thresholds, torch.float32, (n_thr,), device)
    _check(kernel, "order", order, torch.int32, (n_thr,), device)
    _check(kernel, "confmat", confmat, torch.int32, (n_thr, n_cols, 2, 2), device)
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors only, got them on {device}")
    if confmat.data_ptr() % 16:
        raise ValueError(f"{kernel}: `confmat` must be 16-byte aligned")

    geometry = plan(n_rows, n_cols, n_thr, _sms(device), one_wave=bool(row_shape))
    new = torch.empty_like(confmat)
    # the two (T+1, C) histograms, their (S, C) epilogue segment sums, actpos (C,) and
    # total; the launcher zeroes them on the stream before the histogram kernel
    scratch = torch.empty(
        (2 * (n_thr + 1) * n_cols + 2 * geometry.epilogue_grid[1] * n_cols + n_cols + 1,),
        dtype=torch.int32, device=device,
    )
    args = (
        probs.data_ptr(), target.data_ptr(), weights.data_ptr(), sorted_thresholds.data_ptr(), order.data_ptr(),
        confmat.data_ptr(), new.data_ptr(), scratch.data_ptr(), n_rows, n_cols, n_thr, geometry.tile_c,
        geometry.bins_per_range, geometry.rows_per_block, geometry.bins_per_warp,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if device.index in (None, torch.cuda.current_device()):
        err = _launch_fn(kernel)(*args)
    else:
        with torch.cuda.device(device):
            err = _launch_fn(kernel)(*args)
    if err != 0:
        raise RuntimeError(f"{kernel}: launch failed with CUDA error {err}")
    return new


def binned_confmat_multiclass(
    confmat: Tensor, probs: Tensor, target: Tensor, weights: Tensor, sorted_thresholds: Tensor, order: Tensor
) -> Tensor:
    """New ``(T, C, 2, 2)`` int32 state: ``confmat`` plus this batch's counts, by the CUDA kernel.

    ``state[t, c] = [[tn, fp], [fn, tp]]`` at the caller's threshold ``t``.
    The result is a new tensor; ``confmat`` is only read. ``chip_smoke.py``
    holds it equal (``torch.equal``, no tolerance) to
    ``_binned_confmat_multiclass_accumulate_plain`` on the card.

    Args:
        confmat: ``(T, C, 2, 2)`` int32 state, 16-byte aligned.
        probs: ``(N, C)`` float32 scores, ``N < 2**31``.
        target: ``(N,)`` int32 class labels; one outside ``[0, C)`` makes the
            row a negative for every class.
        weights: ``(N,)`` float32 0/1 row mask (0 for ignored rows).
        sorted_thresholds: ``(T,)`` float32, ascending, NaNs last
            (``_sort_thresholds``).
        order: ``(T,)`` int32, the caller's index of each sorted threshold.

    Every check raises ``ValueError`` before anything is built or launched;
    a CUDA error of the launch raises ``RuntimeError``.
    """
    new = _update("binned_confmat_multiclass", confmat, probs, target, weights, sorted_thresholds, order, ())
    binned_confmat_multiclass.launches += 1
    return new


def binned_confmat_multilabel(
    confmat: Tensor, probs: Tensor, target: Tensor, weights: Tensor, sorted_thresholds: Tensor, order: Tensor
) -> Tensor:
    """New ``(T, L, 2, 2)`` int32 state: ``confmat`` plus this batch's per-label counts, by the CUDA kernel.

    ``state[t, l] = [[tn, fp], [fn, tp]]`` at the caller's threshold ``t``,
    with ``tp[t, l] = sum_n w[n, l] * target[n, l] * [probs[n, l] >= thr[t]]``
    and ``total[l] = sum_n w[n, l]``. The binary update is its case ``L = 1``.
    The counts are int32, exact to 2**31 - 1 a launch (the JAX update sums
    float32, exact below 2**24 a cell a batch). ``chip_smoke.py`` holds it
    equal (``torch.equal``) to ``_binned_confmat_multilabel_accumulate_plain``
    on the card.

    Args:
        confmat: ``(T, L, 2, 2)`` int32 state, 16-byte aligned.
        probs: ``(N, L)`` float32 scores, ``N < 2**31``.
        target: ``(N, L)`` int32 labels (0/1; each element counts ``w * target``).
        weights: ``(N, L)`` float32 0/1 element mask (0 for ignored elements).
        sorted_thresholds: ``(T,)`` float32, ascending, NaNs last.
        order: ``(T,)`` int32, the caller's index of each sorted threshold.

    Every check raises ``ValueError`` before anything is built or launched;
    a CUDA error of the launch raises ``RuntimeError``.
    """
    row_shape = (probs.shape[1],) if probs.ndim == 2 else ()
    new = _update("binned_confmat_multilabel", confmat, probs, target, weights, sorted_thresholds, order, row_shape)
    binned_confmat_multilabel.launches += 1
    return new


binned_confmat_multiclass.launches = 0
binned_confmat_multilabel.launches = 0
