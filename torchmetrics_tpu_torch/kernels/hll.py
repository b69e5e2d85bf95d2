"""Launcher of the ``hll_insert`` CUDA kernel (``csrc/hll.cu``) and its plain version.

:func:`hll_insert` folds the n-gram windows of a ``(B, T)`` batch of int32
token ids into DistinctNGrams' HyperLogLog registers, in place, and gives the
new float32 count of valid windows, in one launch: each window's chained
``mix32`` key, its register index and rank, and an ``atomicMax``, with no
``(rows, n)`` window stack. A window holding ``ignore_index`` is skipped and
not counted. It counts its launches in ``hll_insert.launches`` and takes CUDA
tensors only.

:func:`_hll_insert_plain` is the JAX package's form in plain PyTorch
(the windows and keys of :func:`torchmetrics_tpu_torch.text.distinct.window_keys`,
then ``HyperLogLog.insert_batch``), out of place. The dispatch by device is
``text.distinct.DistinctNGrams._update``.

Integer maxima do not depend on the order of the atomics, so the registers
are JAX's bit for bit, from launch to launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import cdiv, check_tensor, launch_on, load_library, sm_count, zero_scratch
from torchmetrics_tpu_torch.sketches.cardinality import HyperLogLog

SOURCE = "hll"
THREADS = 256  # kThreads
SHARED_PRECISION = 14  # kSharedPrecision: a block's copy of the registers in shared memory up to here
MIN_WINDOWS_PER_THREAD = 4
BLOCKS_PER_SM = 4

_launch: Optional[ctypes._CFuncPtr] = None


def blocks_for(n_windows: int, precision: int, sm_count: int) -> int:
    """Blocks of a launch: at least ``MIN_WINDOWS_PER_THREAD`` windows a thread and, with the registers in shared
    memory, at least as many windows a block as registers (each block zeroes and flushes its copy)."""
    per_block = THREADS * MIN_WINDOWS_PER_THREAD
    if precision <= SHARED_PRECISION:
        per_block = max(per_block, 1 << precision)
    return max(1, min(cdiv(n_windows, per_block), BLOCKS_PER_SM * sm_count))


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).hll_insert_launch
        p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
        fn.argtypes = [p, ll, i, i, i, ll, i, u, p, p, p, p, p, i, p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _hll_insert_plain(registers: Tensor, total: Tensor, tokens: Tensor, ngram: int, ignore_index: Optional[int],
                      hll: HyperLogLog) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch :func:`hll_insert`: the new ``(registers, total)``, the inputs left as they are."""
    from torchmetrics_tpu_torch.text.distinct import window_keys  # the metric imports this module

    keys, valid = window_keys(tokens, ngram, ignore_index)
    return hll.insert_batch(registers, keys, mask=valid), total + valid.sum()


def hll_insert(registers: Tensor, total: Tensor, tokens: Tensor, ngram: int, ignore_index: Optional[int],
               hll: HyperLogLog) -> Tuple[Tensor, Tensor]:
    """Fold a batch's windows into ``registers`` in place by the CUDA kernel; returns ``(registers, new total)``.

    ``chip_smoke.py`` holds it against :func:`_hll_insert_plain` on the card:
    the registers and the total equal bit for bit.

    Args:
        registers: int32 ``(2**precision,)``, contiguous, on a CUDA device.
        total: float32 ``()``, the count of valid windows so far.
        tokens: int32 ``(B, T)``, contiguous.
        ngram: the window length; a batch with T < n has no windows.
        ignore_index: the token id of padding, or None.
        hll: the register layout (``precision`` 4-18, ``seed``).

    Every check raises ``ValueError`` before anything is built or launched; a
    CUDA error of the launch raises ``RuntimeError``. A batch without windows
    launches nothing.
    """
    device = registers.device
    if tokens.ndim != 2:
        raise ValueError(f"hll_insert takes (B, T) tokens, got {tuple(tokens.shape)}")
    if ngram < 1:
        raise ValueError(f"hll_insert needs ngram >= 1, got {ngram}")
    check_tensor("hll_insert", "registers", registers, torch.int32, (hll.m,), device)
    check_tensor("hll_insert", "total", total, torch.float32, (), device)
    check_tensor("hll_insert", "tokens", tokens, torch.int32, tuple(tokens.shape), device)
    if device.type != "cuda":
        raise ValueError(f"hll_insert takes CUDA tensors, got {device}")
    n_seqs, length = tokens.shape
    span = length - ngram + 1
    if n_seqs == 0 or span < 1:
        return registers, total.clone()
    new_total = torch.empty((), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    scratch = zero_scratch(device, stream, "hll", 16)  # the 64-bit valid-window sum, then the 32-bit ticket
    has_ignore = ignore_index is not None
    blocks = blocks_for(n_seqs * span, hll.precision, sm_count(device))
    args = (tokens.data_ptr(), n_seqs, length, ngram, int(has_ignore), int(ignore_index) if has_ignore else 0,
            hll.precision, hll.seed & 0xFFFFFFFF, registers.data_ptr(), total.data_ptr(), new_total.data_ptr(),
            scratch.data_ptr(), scratch.data_ptr() + 8, blocks, stream)
    launch_on("hll_insert", device, _launch_fn(), args)
    hll_insert.launches += 1
    return registers, new_total


hll_insert.launches = 0
