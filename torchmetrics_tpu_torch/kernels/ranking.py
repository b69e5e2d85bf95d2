"""Launcher of the ``ranking_pairs`` CUDA kernel (``csrc/ranking.cu``).

:func:`ranking_pairs` gives the per-sample coverage error, label ranking
average precision or ranking loss of an ``(N, L)`` batch, float32 ``(N,)``,
in one launch and without the ``(N, L, L)`` comparison tensors of the JAX
functions: a block keeps a row in shared memory and counts its pairs there.
The callers take ``.mean()`` as the JAX functions do. It counts its launches
in ``ranking_pairs.launches`` and takes CUDA tensors only. Its plain
version, the JAX formulas transliterated (per sample), is
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

from torchmetrics_tpu_torch.kernels._build import cdiv, launch_on, load_library, sm_count, zero_tickets

SOURCE = "ranking"
MEASURES = {"coverage": 0, "lrap": 1, "loss": 2}
MAX_LABELS = 12_288  # a row of (score, rel, irr, valid) float4s in a block's shared memory: 192 KB
MAX_ROWS = 2**31 - 1  # one block a row along grid.x
MAX_THREADS = 512
OWN = 4  # labels i a thread compares with each j at once (csrc/ranking.cu kOwn)
MIN_CHUNK = 128  # labels i a block owns at least when a row is split over blocks
BLOCKS_PER_SM = 2
TARGET_KINDS = {torch.int32: 0, torch.int64: 1}

_launch: Optional[ctypes._CFuncPtr] = None


class Plan(NamedTuple):
    splits: int  # blocks a row (grid.y), each owning `chunk` labels i
    chunk: int
    threads: int
    shared_bytes: int


@functools.lru_cache(maxsize=256)
def plan(n_rows: int, n_labels: int, measure: str, sm_count: int) -> Plan:
    """The launch geometry for ``n_rows`` rows of ``n_labels`` labels."""
    shared = n_labels * 16 + 32 * 4
    if measure == "coverage":  # O(L) a row: one block
        return Plan(1, n_labels, min(MAX_THREADS, _round32(n_labels)), shared)
    splits = max(1, min(cdiv(BLOCKS_PER_SM * sm_count, n_rows), cdiv(n_labels, MIN_CHUNK)))
    chunk = cdiv(n_labels, splits)
    splits = cdiv(n_labels, chunk)
    return Plan(splits, chunk, min(MAX_THREADS, _round32(cdiv(chunk, OWN))), shared)


def _round32(n: int) -> int:
    return max(32, 32 * cdiv(n, 32))


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).ranking_pairs_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, ctypes.c_longlong, i, p, p, p, i, i, i, p]
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

    geometry = plan(n_rows, n_labels, measure, sm_count(device))
    partial = torch.empty((n_rows, geometry.splits) if geometry.splits > 1 else (1,), dtype=torch.float32,
                          device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (
        preds.data_ptr(), target.data_ptr(), TARGET_KINDS[target.dtype], n_rows, n_labels,
        int(ignore_index is not None), int(ignore_index or 0), MEASURES[measure], out.data_ptr(),
        partial.data_ptr(), zero_tickets(device, stream, n_rows).data_ptr(), geometry.splits, geometry.chunk,
        geometry.threads, stream,
    )
    launch_on("ranking_pairs", device, _launch_fn(), args)
    ranking_pairs.launches += 1
    return out


ranking_pairs.launches = 0
