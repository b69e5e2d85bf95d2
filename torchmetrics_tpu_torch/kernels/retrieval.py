"""Launcher of the ``retrieval_groups`` CUDA kernel (``csrc/retrieval.cu``).

:func:`retrieval_groups` takes a batch of queries whose rows are already in
order of query id (``functional.retrieval.kernels.query_layout``: a stable
sort of the ids and the offsets of each query's run) and, in one launch, puts
each query's documents in order of score (stable, NaN last, ``-0.0`` tied
with ``+0.0``) and reduces them to one float32 value a query, or writes the
ranked layout: a query with few relevant documents by counting the words
above each of them, the rest by a stable radix sort. It counts its launches
in ``retrieval_groups.launches`` and
takes CUDA tensors only. Its plain version is
``functional.retrieval.kernels._retrieval_scores_plain`` (the JAX
formulas transliterated), which the dispatch ``retrieval_scores`` takes for
CPU tensors, and ``rank_groups``' two stable sorts for the ranked layout.

:func:`plan` is the launch geometry, kept in Python so that the CPU tests
reach it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import launch_on, load_library

SOURCE = "retrieval"
MEASURES = {"precision": 0, "recall": 1, "hit_rate": 2, "fall_out": 3, "average_precision": 4,
            "reciprocal_rank": 5, "r_precision": 6, "ndcg": 7, "auroc": 8, "ranked": 9}
MAX_THREADS = 1024
MAX_ITEMS = 16  # words a thread of the short path
SHARED_WIDTH = MAX_ITEMS * MAX_THREADS  # the longest query sorted in shared memory: 16,384
LONG_TILE = 8 * MAX_THREADS  # the long path's tile: 8 keys a thread
DIGITS = 256  # 8 bits a radix pass
MAX_POSITIVES = 256  # the counting path's list of positives in shared memory
# the kernel's kCountShort and kCountLong, for the tests: a query with at most this many positive targets
# takes the counting path (n x n_pos compares), the rest the radix sort; between the crossovers of
# tools/kernel_ablation.py's retrieval section (AUROC's ~38 positives at 256 documents to ~125 at 16,384,
# AP's ~63 to ~195; at 100,000 documents AUROC's ~165, AP's ~230)
COUNT_SHORT = 64
COUNT_LONG = 192
WARP_WIDTH = 256  # up to this width a query's block is one warp, 8 words a lane at most
ITEMS = 8  # words a thread above WARP_WIDTH (16 at SHARED_WIDTH): at MS MARCO's 1,000 documents, 8 ran the
# counting path 0.063 against 0.077 ms and the sort path 0.24 against 0.27
MAX_ROWS = 2**30  # ranks and rows are int32 in the kernel; the long path's scratch is 2 words a row

_launch: Optional[ctypes._CFuncPtr] = None
_p, _i = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_p, _p, _p, _i, _i, _i, _i, ctypes.c_float, _i, _p, _p, _p, _p, _i, _i, _p]  # retrieval_groups_launch


class Plan(NamedTuple):
    threads: int  # threads a block: one block a query
    width: int  # the widest query's register sort: a power of two, at most SHARED_WIDTH
    long: bool  # some query is longer than SHARED_WIDTH: its words sort through a global scratch
    shared_bytes: int  # dynamic: the widest sort's keys, values and digit histogram of its warps (or more)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.lru_cache(maxsize=256)
def plan(longest: int) -> Plan:
    """The launch geometry for a batch whose longest query has ``longest`` documents.

    A warp a query up to ``WARP_WIDTH`` (8 words a lane at most), else a block
    of ``width / ITEMS`` threads (16 words a thread at ``SHARED_WIDTH``); past
    it 1,024 threads and the long path.
    Every query of the launch runs in a block of that many threads, with
    ``max(threads, next_pow2(n)) / threads`` words a thread.

    Dynamic shared memory: the sort path's keys and positions (4 bytes each
    a word of the width) and its two histograms of 256 digits a warp (a
    pass's and the next's); at least the counting path's list (a word, a
    target and three counts a positive); with the long path, its tile of
    8,192 keys and positions, two histograms of 32 warps, the four digits'
    histograms over the query and the digits' starts.
    """
    width = max(32, _next_pow2(longest))
    if width > SHARED_WIDTH:
        threads, width, long = MAX_THREADS, SHARED_WIDTH, True
    else:
        long = False
        if width <= WARP_WIDTH:
            threads = 32
        else:
            threads = width // max(ITEMS, width // MAX_THREADS)
    shared = max(8 * width + 2 * 4 * DIGITS * (threads // 32), (8 + 4 + 12) * MAX_POSITIVES)
    if long:
        shared = max(shared, 8 * LONG_TILE + 2 * 4 * DIGITS * (MAX_THREADS // 32) + 4 * 4 * DIGITS + 4 * DIGITS)
    return Plan(threads, width, long, shared)


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).retrieval_groups_launch
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def retrieval_groups(preds: Tensor, target: Tensor, offsets: Tensor, measure: str, top_k: Optional[int] = None,
                     adaptive_k: bool = False, *, longest: int) -> Tuple[Tensor, Tensor]:
    """Every query's ``measure``, or the ranked layout, in one launch.

    ``chip_smoke.py`` holds it against the plain version on the card: counts
    and the ranked layout equal, AP, NDCG and AUROC within 1e-6 relative
    plus the float32 summation bound of the plain version's sums.

    Args:
        preds: float32 scores ``(n,)``, the rows in order of query id.
        target: float32 targets ``(n,)``, in the same order.
        offsets: int64 ``(G + 1,)``, query g's rows ``offsets[g]:offsets[g + 1]``, none empty.
        measure: a key of ``MEASURES``.
        top_k: only the first ``top_k`` ranks count (None: all).
        adaptive_k: precision divides by ``min(top_k, n)`` instead of ``top_k``.
        longest: the most rows of a query (``query_layout`` gives it); it sets the launch's plan.

    Returns:
        ``(scores, n_rel)``, float32 ``(G,)`` each (``n_rel`` the sum of the
        query's targets), or for ``"ranked"`` ``(rows, target)``: int32 and
        float32 ``(n,)``, at ``offsets[g] + r`` the row of query g's rank r
        and its target.

    Every check raises ``ValueError`` before anything is built or launched; a
    CUDA error of the launch raises ``RuntimeError``. No query launches nothing.
    """
    if measure not in MEASURES:
        raise ValueError(f"retrieval_groups: measure must be one of {sorted(MEASURES)}, got {measure!r}")
    if top_k is not None and not (isinstance(top_k, int) and top_k > 0):
        raise ValueError(f"retrieval_groups: top_k must be a positive integer or None, got {top_k!r}")
    if preds.dtype != torch.float32 or target.dtype != torch.float32:
        raise ValueError(f"retrieval_groups takes float32 scores and targets, got {preds.dtype} and {target.dtype}")
    if offsets.dtype != torch.int64 or offsets.ndim != 1 or offsets.shape[0] < 1:
        raise ValueError(f"retrieval_groups takes int64 offsets (G + 1,), got {offsets.dtype} {tuple(offsets.shape)}")
    if preds.ndim != 1 or target.shape != preds.shape:
        raise ValueError(f"retrieval_groups: preds and target must both be (n,), got {tuple(preds.shape)} and "
                         f"{tuple(target.shape)}")
    n, n_groups = preds.shape[0], offsets.shape[0] - 1
    if n >= MAX_ROWS:
        raise ValueError(f"retrieval_groups takes fewer than 2**30 rows a launch, got {n}")
    device = preds.device
    for name, x in (("preds", preds), ("target", target), ("offsets", offsets)):
        if x.device != device:
            raise ValueError(f"retrieval_groups: `{name}` is on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"retrieval_groups: `{name}` must be contiguous")
    if device.type != "cuda":
        raise ValueError(f"retrieval_groups runs on CUDA tensors only, got them on {device}")
    ranked = measure == "ranked"
    out = torch.empty((n if ranked else n_groups,), dtype=torch.float32, device=device)
    second = torch.empty((n,) if ranked else (n_groups,), dtype=torch.int32 if ranked else torch.float32,
                         device=device)
    if n_groups == 0:
        return (second, out) if ranked else (out, second)
    g = plan(longest)
    scratch = torch.empty((2 * n,), dtype=torch.int64, device=device) if g.long else None
    args = (
        preds.data_ptr(), target.data_ptr(), offsets.data_ptr(), n_groups, MEASURES[measure], int(top_k is not None),
        min(top_k or 0, 2**31 - 1), float(np.float32(top_k or 0)), int(adaptive_k),
        out.data_ptr(), 0 if ranked else second.data_ptr(), second.data_ptr() if ranked else 0,
        0 if scratch is None else scratch.data_ptr(), g.threads, g.shared_bytes,
        torch.cuda.current_stream(device).cuda_stream,
    )
    launch_on("retrieval_groups", device, _launch_fn(), args)
    retrieval_groups.launches += 1
    return (second, out) if ranked else (out, second)


retrieval_groups.launches = 0
