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

Plan and scratch. :func:`plan` is the launch geometry, kept in Python so
that the CPU tests reach it: W warps a row, each width where it measured
fastest (``tools/kernel_ablation.py --sections calibration-widths``): 4
while every row's four warps fit one wave of ``BLOCKS_PER_SM`` blocks an
SM, 2 while the rows would fit that wave at one warp each, 1 beyond (the
argmax of the probabilities divides only where ``e`` can tie ``1 / sum``);
and one block when the batch fits one round of a block (a round: 8 / W
rows, 256 short rows or 1,024 binary scores), which writes the state from
its shared memory. A grid of several blocks adds its
histograms into the stream's accumulator (``SCRATCH_BYTES``, from
``_build.zero_scratch``, zeroed once), and its last block writes the state
and zeroes the accumulator again.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import cdiv, launch_on, load_library, sm_count, zero_scratch

SOURCE = "calibration"
MAX_BINS = 1023  # two histograms of (n_bins + 1) x 16 bytes and 4 words in a block's shared memory: 32,784 bytes
MAX_ROWS = 2**31 - 1  # the counts are int32
THREADS = 256
WARPS = THREADS // 32
CACHED_SCORES = 1024  # W warps keep a row of up to 32 / W scores a lane in registers
ROW_MIN_SCORES = 32  # warps a row from this many scores a row; a thread a row below
BINARY_ITEMS = 4  # binary scores a thread loads before it bins any
BLOCKS_PER_SM = 4  # the grid's cap an SM; its warps are one wave, which sets the warps a row
PRED_KINDS = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
TARGET_KINDS = {torch.int32: 0, torch.int64: 1}
MODES = {"rows": 0, "long_rows": 1, "short_rows": 2, "binary": 3}


def _shared_bytes(nb: int) -> int:
    """Two histograms: 2 x nb uint64 confidence sums, then acc, count, nan, outside and ticket words."""
    return 2 * nb * 8 + (4 * nb + 4) * 4


SCRATCH_BYTES = _shared_bytes(MAX_BINS + 1)  # the stream's accumulator, laid out as a block's histograms

_launch: Optional[ctypes._CFuncPtr] = None


class Plan(NamedTuple):
    mode: str  # "rows" (W warps a row in registers), "long_rows", "short_rows" (a thread a row), "binary"
    warps_per_row: int  # W, in "rows" mode; else 1
    blocks: int  # 1: the block writes the state itself, no accumulator
    threads: int
    shared_bytes: int  # the block's two histograms


@functools.lru_cache(maxsize=256)
def plan(n_rows: int, n_scores: Optional[int], n_bins: int, sm_count: int) -> Plan:
    """The launch geometry for ``n_rows`` rows of ``n_scores`` scores (``None``: binary scores)."""
    shared = _shared_bytes(n_bins + 1)
    warps = 1
    if n_scores is None:
        mode, per_round = "binary", THREADS * BINARY_ITEMS
    elif n_scores < ROW_MIN_SCORES:
        mode, per_round = "short_rows", THREADS
    elif n_scores > CACHED_SCORES:
        mode, per_round = "long_rows", WARPS
    else:
        mode = "rows"
        wave = BLOCKS_PER_SM * sm_count * WARPS
        warps = 4 if 4 * n_rows <= wave else 2 if n_rows <= wave else 1
        per_round = WARPS // warps
    rounds = cdiv(n_rows, per_round)
    blocks = 1 if rounds == 1 else min(rounds, BLOCKS_PER_SM * sm_count)
    return Plan(mode, warps, blocks, THREADS, shared)


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).calibration_bins_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [
            p, i, p, i,  # preds, kind, target, kind
            ll, i, i, i, ll,  # rows, scores, n_bins, has_ignore, ignore_index
            p, p, p, p, p, p,  # old conf, acc, count; new conf, acc, count
            p, p, i, i, i, p,  # accumulator (conf, int words), mode, warps a row, blocks, stream
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
    stream = torch.cuda.current_stream(device).cuda_stream
    scratch = zero_scratch(device, stream, SOURCE, SCRATCH_BYTES)
    args = (
        preds.data_ptr(), PRED_KINDS[preds.dtype], target.data_ptr(), TARGET_KINDS[target.dtype],
        n_rows, num_classes or 1, n_bins, int(ignore_index is not None), int(ignore_index or 0),
        conf_sum.data_ptr(), acc_sum.data_ptr(), count.data_ptr(),
        new_conf.data_ptr(), new_acc.data_ptr(), new_count.data_ptr(),
        scratch.data_ptr(), scratch.data_ptr() + 2 * nb * 8,  # the accumulator's sums, then its integer words
        MODES[geometry.mode], geometry.warps_per_row, geometry.blocks, stream,
    )
    launch_on("calibration_bins", device, _launch_fn(), args)
    calibration_bins.launches += 1
    return new_conf, new_acc, new_count


calibration_bins.launches = 0

