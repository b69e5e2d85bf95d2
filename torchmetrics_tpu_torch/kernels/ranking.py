"""Launcher of the ``ranking_pairs`` CUDA kernel (``csrc/ranking.cu``).

:func:`ranking_pairs` gives the per-sample coverage error, label ranking
average precision or ranking loss of an ``(N, L)`` batch, float32 ``(N,)``,
in one launch and without the ``(N, L, L)`` comparison tensors of the JAX
functions: for LRAP and the loss a warp or a block sorts each row's labels
by score and scans them once; coverage takes a min and a count. The callers
take ``.mean()`` as the JAX functions do. It counts its launches in
``ranking_pairs.launches`` and takes CUDA tensors only. Its plain version,
the JAX formulas transliterated (per sample), is
``functional.classification.ranking._ranking_per_sample_plain``, which the
dispatch ``_ranking_per_sample`` takes for CPU tensors.

:func:`plan` is the launch geometry, kept in Python so that the CPU tests
reach it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import cdiv, launch_on, load_library, sm_count

SOURCE = "ranking"
MEASURES = {"coverage": 0, "lrap": 1, "loss": 2}
MAX_LABELS = 16_384  # the sort's width at its largest: 16 words a thread in a block of 1,024
MAX_ROWS = 2**31 - 1  # a row a warp or a block along grid.x
MAX_THREADS = 1024
COVERAGE_THREADS = 512
WARP_WIDTH = 256  # rows up to this many labels sort in one warp, 8 words a lane at most
SMALL_BLOCK_WIDTH = 2048  # up to this width a block's threads sort 4 words each, above it 8 (16 at the largest)
MAX_WARP_ROWS = 8  # rows of a block of warps
BLOCKS_PER_SM = 2
TARGET_KINDS = {torch.int32: 0, torch.int64: 1}

_launch: Optional[ctypes._CFuncPtr] = None


class Plan(NamedTuple):
    width: int  # the sort's width: a power of two >= L (0 for coverage)
    items: int  # words a thread sorts (0 for coverage)
    group: int  # threads a row
    threads: int  # threads a block
    blocks: int
    shared_bytes: int  # dynamic: the padded sort buffer of a block's row, or coverage's row of scores


@functools.lru_cache(maxsize=256)
def plan(n_rows: int, n_labels: int, measure: str, sm_count: int) -> Plan:
    """The launch geometry for ``n_rows`` rows of ``n_labels`` labels.

    Coverage: a block a row, its scores in shared memory. LRAP and the loss: a warp a row up to
    ``WARP_WIDTH`` labels (several rows a block, as many as keep
    ``BLOCKS_PER_SM`` blocks an SM), else a block a row of ``width / items``
    threads with the sort buffer in shared memory, a word of padding every 16:
    4 words a thread up to ``SMALL_BLOCK_WIDTH`` (more threads for the few
    rows such batches have), 8 above, 16 at 16,384 (1,024 threads).
    """
    rows = max(n_rows, 1)
    if measure == "coverage":  # the row's scores and 32 floats of scratch in shared memory
        threads = min(COVERAGE_THREADS, 32 * cdiv(n_labels, 32))
        return Plan(0, 0, threads, threads, rows, (n_labels + 32) * 4)
    width = max(32, 1 << (n_labels - 1).bit_length())
    if width <= WARP_WIDTH:
        per_block = max(1, min(MAX_WARP_ROWS, rows // (BLOCKS_PER_SM * sm_count)))
        return Plan(width, width // 32, 32, 32 * per_block, cdiv(rows, per_block), 0)
    items = 4 if width <= SMALL_BLOCK_WIDTH else max(8, width // MAX_THREADS)
    group = width // items
    return Plan(width, items, group, group, rows, (width + width // 16) * 8)


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).ranking_pairs_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, ctypes.c_longlong, i, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def ranking_pairs(preds: Tensor, target: Tensor, measure: str, ignore_index: Optional[int] = None) -> Tensor:
    """Per-sample ``measure`` (``"coverage"``, ``"lrap"`` or ``"loss"``) of a batch, float32 ``(N,)``.

    ``chip_smoke.py`` holds it against the plain version on the card
    (coverage and the loss equal, LRAP within 1e-6 relative).

    Args:
        preds: float32 scores ``(N, L)``.
        target: int32 or int64 targets ``(N, L)``; an int64 target counts as
            its low 32 bits, as in the JAX package's int32.
        measure: which measure.
        ignore_index: labels whose target equals it are not valid.

    Every check raises ``ValueError`` before anything is built or launched; a
    CUDA error of the launch raises ``RuntimeError``. An empty batch launches
    nothing.
    """
    if measure not in MEASURES:
        raise ValueError(f"ranking_pairs: measure must be one of {sorted(MEASURES)}, got {measure!r}")
    if preds.dtype != torch.float32:
        raise ValueError(f"ranking_pairs takes float32 scores, got {preds.dtype}")
    if target.dtype not in TARGET_KINDS:
        raise ValueError(f"ranking_pairs takes int32 or int64 targets, got {target.dtype}")
    if preds.ndim != 2 or target.shape != preds.shape:
        raise ValueError(f"ranking_pairs: preds and target must both be (N, L), got {tuple(preds.shape)} and "
                         f"{tuple(target.shape)}")
    n_rows, n_labels = preds.shape
    if n_labels < 1:
        raise ValueError("ranking_pairs needs at least one label a row")
    if n_labels > MAX_LABELS:
        raise ValueError(f"ranking_pairs takes at most {MAX_LABELS} labels a row (shared memory), got {n_labels}")
    if n_rows > MAX_ROWS:
        raise ValueError(f"ranking_pairs takes fewer than 2**31 rows a launch, got {n_rows}")
    device = preds.device
    for name, x in (("preds", preds), ("target", target)):
        if x.device != device:
            raise ValueError(f"ranking_pairs: `{name}` is on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"ranking_pairs: `{name}` must be contiguous")
    if device.type != "cuda":
        raise ValueError(f"ranking_pairs runs on CUDA tensors only, got them on {device}")
    if ignore_index is not None and not -(2**63) <= ignore_index < 2**63:
        raise ValueError(f"ranking_pairs: ignore_index {ignore_index} is outside int64")
    out = torch.empty((n_rows,), dtype=torch.float32, device=device)
    if n_rows == 0:
        return out

    g = plan(n_rows, n_labels, measure, sm_count(device))
    args = (
        preds.data_ptr(), target.data_ptr(), TARGET_KINDS[target.dtype], n_rows, n_labels,
        int(ignore_index is not None), int(ignore_index or 0), MEASURES[measure], out.data_ptr(),
        g.width, g.items, g.group, g.threads, g.blocks, g.shared_bytes, torch.cuda.current_stream(device).cuda_stream,
    )
    launch_on("ranking_pairs", device, _launch_fn(), args)
    ranking_pairs.launches += 1
    return out


ranking_pairs.launches = 0
