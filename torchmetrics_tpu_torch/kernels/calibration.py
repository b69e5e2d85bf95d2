"""Launcher of the ``calibration_bins`` CUDA kernel (``csrc/calibration.cu``).

:func:`calibration_bins` is the fused calibration-error state update: the old
``(n_bins + 1,)`` state (``conf_sum`` float32, ``acc_sum`` and ``count``
int32) and one batch of scores give the new state, out of place, in one
launch. Multiclass scores are viewed as ``(M, C)`` rows (the JAX
``reshape(-1, C)``), softmaxed iff any score of the batch lies outside
[0, 1]; binary scores (``num_classes=None``) are sigmoided on the same rule.
The confidence is the row's max probability, the accuracy whether its argmax
(``jnp.argmax``'s rules) is the target (binary: the target itself), the bin
``clip(floor(conf * n_bins), 0, n_bins)`` with NaN in bin 0 and +inf in bin
``n_bins``; rows whose target equals ``ignore_index`` add nothing to the
counts. It counts its launches in ``calibration_bins.launches`` and takes
CUDA tensors only. Its plain version, the JAX functions transliterated, is
``functional.classification.calibration_error._calibration_accumulate_plain``,
which the dispatch ``_calibration_accumulate`` takes for CPU tensors.

Two differences from a float32 scatter-add, both kept on purpose: the
batch's confidences are summed in 32.32 fixed point (deterministic, exact to
2**-33 a row, rounded once to float32), and the counts are int32 (JAX sums
float32 0/1 weights a batch, exact below 2**24 a bin).

:func:`plan` is the launch geometry, kept in Python so that the CPU tests
reach it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import cdiv, launch_on, load_library, sm_count, zero_tickets

SOURCE = "calibration"
MAX_BINS = 1023  # two histograms of (n_bins + 1) x 16 bytes in a block's shared memory: 32 KB
MAX_ROWS = 2**31 - 1  # the counts are int32
THREADS = 256
CACHED_SCORES = 1024  # a warp keeps a row of up to 32 scores a lane in registers
ROW_MIN_SCORES = 32  # a warp a row from this many scores a row; a thread a row below
BLOCKS_PER_SM = 2

PRED_KINDS = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
TARGET_KINDS = {torch.int32: 0, torch.int64: 1}
MODES = {"rows": 0, "long_rows": 1, "short_rows": 2, "binary": 3}

_launch: Optional[ctypes._CFuncPtr] = None


class Plan(NamedTuple):
    mode: str  # "rows" (a warp a row in registers), "long_rows", "short_rows" (a thread a row), "binary"
    blocks: int
    threads: int
    shared_bytes: int  # the block's two histograms


@functools.lru_cache(maxsize=256)
def plan(n_rows: int, n_scores: Optional[int], n_bins: int, sm_count: int) -> Plan:
    """The launch geometry for ``n_rows`` rows of ``n_scores`` scores (``None``: binary scores)."""
    nb = n_bins + 1
    shared = nb * 2 * 8 + (4 * nb + 2) * 4
    cap = BLOCKS_PER_SM * sm_count
    if n_scores is None:
        return Plan("binary", max(1, min(cdiv(n_rows, THREADS), cap)), THREADS, shared)
    if n_scores < ROW_MIN_SCORES:
        return Plan("short_rows", max(1, min(cdiv(n_rows, THREADS), cap)), THREADS, shared)
    mode = "rows" if n_scores <= CACHED_SCORES else "long_rows"
    return Plan(mode, max(1, min(cdiv(n_rows, THREADS // 32), cap)), THREADS, shared)


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).calibration_bins_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [
            p, i, p, i,  # preds, kind, target, kind
            ll, i, i, i, ll,  # rows, scores, n_bins, has_ignore, ignore_index
            p, p, p, p, p, p,  # old conf, acc, count; new conf, acc, count
            p, p, p, i, i, p,  # conf_part, int_part, ticket, mode, blocks, stream
        ]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def calibration_bins(
    conf_sum: Tensor,
    acc_sum: Tensor,
    count: Tensor,
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int],
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The new ``(conf_sum, acc_sum, count)`` after one batch, by the CUDA kernel.

    ``chip_smoke.py`` holds it against the plain version on the card: the
    integer states equal except for rows whose confidence lies within 1e-5
    of a bin edge (the kernel's ``expf`` and sum order against PyTorch's),
    ``conf_sum`` within 1e-5 relative.

    Args:
        conf_sum, acc_sum, count: the old state, ``(n_bins + 1,)`` float32,
            int32, int32; read only.
        preds: float32, float16 or bfloat16 scores, widened to float32 on load:
            any shape whose size is a multiple of ``num_classes`` (rows of C
            scores in memory order), or ``(N,)`` for ``num_classes=None``.
        target: int32 or int64, one label a row; an int64 label counts as its
            low 32 bits, as in the JAX package's int32.
        num_classes: C, or None for binary scores.
        ignore_index: rows whose target equals it add nothing (a NaN
            confidence still makes ``conf_sum[0]`` NaN, as in JAX).

    Every check raises ``ValueError`` before anything is built or launched; a
    CUDA error of the launch raises ``RuntimeError``. An empty batch launches
    nothing and returns copies of the old state.
    """
    nb = conf_sum.shape[0] if conf_sum.ndim == 1 else 0
    for name, x, dtype in (("conf_sum", conf_sum, torch.float32), ("acc_sum", acc_sum, torch.int32),
                           ("count", count, torch.int32)):
        if x.dtype != dtype or x.shape != (nb,) or nb < 2:
            raise ValueError(f"calibration_bins: `{name}` must be ({nb},) {dtype} with n_bins >= 1, "
                             f"got {tuple(x.shape)} {x.dtype}")
    n_bins = nb - 1
    if n_bins > MAX_BINS:
        raise ValueError(f"calibration_bins takes at most {MAX_BINS} bins (shared memory), got {n_bins}")
    if preds.dtype not in PRED_KINDS:
        raise ValueError(f"calibration_bins takes float32, float16 or bfloat16 scores, got {preds.dtype}")
    if target.dtype not in TARGET_KINDS:
        raise ValueError(f"calibration_bins takes int32 or int64 targets, got {target.dtype}")
    if num_classes is None:
        n_rows = preds.numel()
    else:
        if not (isinstance(num_classes, int) and num_classes >= 1) or preds.numel() % num_classes:
            raise ValueError(f"calibration_bins: {preds.numel()} scores are not rows of num_classes={num_classes}")
        n_rows = preds.numel() // num_classes
    if target.numel() != n_rows:
        raise ValueError(f"calibration_bins: {n_rows} rows of scores need {n_rows} targets, got {target.numel()}")
    if n_rows > MAX_ROWS:
        raise ValueError(f"calibration_bins takes fewer than 2**31 rows a launch, got {n_rows}")
    device = conf_sum.device
    for name, x in (("conf_sum", conf_sum), ("acc_sum", acc_sum), ("count", count), ("preds", preds),
                    ("target", target)):
        if x.device != device:
            raise ValueError(f"calibration_bins: `{name}` is on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"calibration_bins: `{name}` must be contiguous")
    if device.type != "cuda":
        raise ValueError(f"calibration_bins runs on CUDA tensors only, got them on {device}")
    if ignore_index is not None and not -(2**63) <= ignore_index < 2**63:
        raise ValueError(f"calibration_bins: ignore_index {ignore_index} is outside int64")
    if n_rows == 0:
        return conf_sum.clone(), acc_sum.clone(), count.clone()

    geometry = plan(n_rows, num_classes, n_bins, sm_count(device))
    new_conf, new_acc, new_count = torch.empty_like(conf_sum), torch.empty_like(acc_sum), torch.empty_like(count)
    conf_part = torch.empty((geometry.blocks, 2, nb), dtype=torch.int64, device=device)
    int_part = torch.empty((geometry.blocks, 4 * nb + 3), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (
        preds.data_ptr(), PRED_KINDS[preds.dtype], target.data_ptr(), TARGET_KINDS[target.dtype],
        n_rows, num_classes or 1, n_bins, int(ignore_index is not None), int(ignore_index or 0),
        conf_sum.data_ptr(), acc_sum.data_ptr(), count.data_ptr(),
        new_conf.data_ptr(), new_acc.data_ptr(), new_count.data_ptr(),
        conf_part.data_ptr(), int_part.data_ptr(), zero_tickets(device, stream, 1).data_ptr(),
        MODES[geometry.mode], geometry.blocks, stream,
    )
    launch_on("calibration_bins", device, _launch_fn(), args)
    calibration_bins.launches += 1
    return new_conf, new_acc, new_count


calibration_bins.launches = 0

