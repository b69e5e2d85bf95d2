"""Launcher of the ``binned_confmat_multilabel`` CUDA kernel (``csrc/binned_multilabel.cu``).

:func:`binned_confmat_multilabel` is the fused per-label binned-curve state
update (the binary update is its case of one label): it checks its inputs,
launches the one kernel of the update on the current stream and counts its
calls in its ``launches`` attribute. It takes CUDA tensors only: the dispatch
between the kernel and its plain PyTorch version, by the device of the
input, is
``functional.classification.precision_recall_curve._binned_confmat_multilabel_accumulate``.

:func:`plan` is the launch geometry, kept in Python so that the CPU tests
reach it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import (
    cdiv, check_tensor, launch_on, load_library, sm_count, zero_tickets,
)

SOURCE = "binned_multilabel"
THREADS = 256  # kThreads in the source
GROUP_LABELS = 8  # labels a block of a large batch: a 32-byte sector of a row's float32 scores
HIST_BUDGET = 64 * 1024  # bytes of a group's two shared histograms, unless one label alone needs more
ONE_CHUNK_ELEMENTS = 32_768  # a label group's rows up to this many elements are one block: no merge
CHUNK_ELEMENTS = 16_384  # above it, row chunks of about this many elements, merged by the last block
MAX_BLOCK_ELEMENTS = 2**30  # a block's element index is int32
BLOCKS_PER_SM = 4  # the most blocks a merged launch spreads over, an SM
MAX_THRESHOLDS = 16384  # one label's bins and the thresholds in a block's shared memory: 196,620 bytes
MAX_ROWS = 2**31 - 1  # int32 counts and row indices

_launch: Optional[ctypes._CFuncPtr] = None


class Plan(NamedTuple):
    labels: int  # labels of a block (a group); the last group may hold fewer
    label_lanes: int  # `labels` rounded up to a power of two: epilogue lanes a bin segment
    groups: int  # grid.x
    chunks: int  # grid.y: row chunks of a group, merged by its last block when more than one
    rows_per_chunk: int
    shared_bytes: int  # dynamic: two (labels, (T + 1) | 1) int32 histograms and T + 1 thresholds


@functools.lru_cache(maxsize=256)
def plan(n_rows: int, n_labels: int, n_thr: int, sm_count: int) -> Plan:
    """The launch geometry for an ``(n_rows, n_labels)`` batch and ``n_thr`` thresholds.

    Label groups, balanced: a small batch (a group's rows at most
    ``ONE_CHUNK_ELEMENTS`` elements, one block each) takes one label a group,
    or as many as keep about one group an SM; a larger one takes up to
    ``GROUP_LABELS`` labels whose histograms fit ``HIST_BUDGET`` (one label
    at least), and cuts a group's rows into chunks of about
    ``CHUNK_ELEMENTS`` elements, no more than ``BLOCKS_PER_SM`` blocks an SM
    over the grid (at least one chunk a group).
    """
    bins = n_thr + 1
    rows = max(n_rows, 1)
    wide = max(1, min(GROUP_LABELS, HIST_BUDGET // (8 * (bins | 1))))
    labels = max(1, min(wide, n_labels // sm_count))
    if rows * labels > ONE_CHUNK_ELEMENTS:
        labels = wide
    groups = cdiv(n_labels, labels)
    labels = cdiv(n_labels, groups)
    groups = cdiv(n_labels, labels)
    elements = rows * labels
    chunks = 1
    if elements > ONE_CHUNK_ELEMENTS:
        chunks = min(cdiv(elements, CHUNK_ELEMENTS), max(1, cdiv(BLOCKS_PER_SM * sm_count, groups)))
    chunks = max(chunks, cdiv(elements, MAX_BLOCK_ELEMENTS))
    rows_per_chunk = cdiv(rows, chunks)
    return Plan(
        labels, 1 << (labels - 1).bit_length(), groups, cdiv(rows, rows_per_chunk), rows_per_chunk,
        (2 * labels * (bins | 1) + bins) * 4,
    )


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).binned_multilabel_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


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
        confmat: ``(T, L, 2, 2)`` int32 state.
        probs: ``(N, L)`` float32 scores, ``N < 2**31``.
        target: ``(N, L)`` int32 labels (0/1; each element counts ``w * target``).
        weights: ``(N, L)`` float32 0/1 element mask (0 for ignored elements).
        sorted_thresholds: ``(T,)`` float32, ascending, NaNs last.
        order: ``(T,)`` int32, the caller's index of each sorted threshold.

    Every check raises ``ValueError`` before anything is built or launched;
    a CUDA error of the launch raises ``RuntimeError``.
    """
    kernel = "binned_confmat_multilabel"
    if probs.ndim != 2:
        raise ValueError(f"{kernel}: `probs` has {probs.ndim} dims, expected 2")
    n_rows, n_labels = probs.shape
    n_thr = sorted_thresholds.shape[0] if sorted_thresholds.ndim == 1 else -1
    if n_labels < 1 or not 1 <= n_thr <= MAX_THRESHOLDS:
        raise ValueError(
            f"{kernel} needs at least one label and 1 to {MAX_THRESHOLDS} thresholds "
            f"in one dimension, got {n_labels} labels and thresholds of shape {tuple(sorted_thresholds.shape)}"
        )
    if n_rows > MAX_ROWS:
        raise ValueError(f"{kernel} takes fewer than 2**31 rows a launch, got {n_rows}")
    device = probs.device
    check_tensor(kernel, "probs", probs, torch.float32, (n_rows, n_labels), device)
    check_tensor(kernel, "target", target, torch.int32, (n_rows, n_labels), device)
    check_tensor(kernel, "weights", weights, torch.float32, (n_rows, n_labels), device)
    check_tensor(kernel, "sorted_thresholds", sorted_thresholds, torch.float32, (n_thr,), device)
    check_tensor(kernel, "order", order, torch.int32, (n_thr,), device)
    check_tensor(kernel, "confmat", confmat, torch.int32, (n_thr, n_labels, 2, 2), device)
    if device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors only, got them on {device}")
    if confmat.data_ptr() % 16:
        raise ValueError(f"{kernel}: `confmat` must be 16-byte aligned")

    g = plan(n_rows, n_labels, n_thr, sm_count(device))
    new = torch.empty_like(confmat)
    stream = torch.cuda.current_stream(device).cuda_stream
    # the row chunks' partial histograms, only where a group's rows are cut into chunks
    partial = None
    if g.chunks > 1:
        partial = torch.empty((g.groups * g.chunks * 2 * g.labels * (n_thr + 1),), dtype=torch.int32, device=device)
    args = (
        probs.data_ptr(), target.data_ptr(), weights.data_ptr(), sorted_thresholds.data_ptr(), order.data_ptr(),
        confmat.data_ptr(), new.data_ptr(), None if partial is None else partial.data_ptr(),
        zero_tickets(device, stream, g.groups).data_ptr(), n_rows, n_labels, n_thr, g.labels, g.label_lanes, g.rows_per_chunk, g.chunks, g.shared_bytes, stream,
    )
    launch_on(kernel, device, _launch_fn(), args)
    binned_confmat_multilabel.launches += 1
    return new


binned_confmat_multilabel.launches = 0
