"""Launcher of the ``sdr_toeplitz`` CUDA kernel (``csrc/sdr_toeplitz.cu``) and its plain version.

:func:`sdr_toeplitz` takes SDR's autocorrelation ``r_0`` and cross-correlation
``b`` rows ``(R, L)`` and gives each row's SDR in dB ``(R,)`` and the solution
``x`` of ``toeplitz(r_0) x = b`` ``(R, L)``, in one launch: a Schur-type
(generator) recursion with a general right-hand side in float64, one block a
system with one barrier a step, no matrix. It counts its launches in
``sdr_toeplitz.launches`` and takes CUDA tensors only. :func:`_sdr_toeplitz_plain` is the JAX package's form in plain
PyTorch: the ``(R, L, L)`` Toeplitz matrix, ``torch.linalg.solve`` in the
inputs' dtype (``solve_ex``: a singular system gives NaN in its row), the coherence and the log ratio. The dispatch by device, dtype
and grad is ``functional.audio.sdr._sdr_from_correlations``.

:func:`plan` is the launcher's block shape, kept in Python so that the CPU
tests reach it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import cdiv, launch_on, load_library

SOURCE = "sdr_toeplitz"
MAX_LENGTH = 8192  # kMaxLength: up to 16 slots of (f, g, x) or (F, G, -R) in registers a thread of 512
MAX_ROWS = 2**31 - 1  # systems along grid.x
MAX_THREADS = 1024  # kMaxThreads: a block's threads at up to 2 slots a thread, half that above
MIN_ENTRIES = 4  # kMinEntries: slots a thread, at least
ENTRIES = (1, 2, 4, 8, 16)  # the kernel's instances: slots a thread

_launch: Optional[ctypes._CFuncPtr] = None


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).sdr_toeplitz_launch
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def plan(length: int) -> Tuple[int, int]:
    """``(entries, threads)`` of a system's block: the smallest of ``ENTRIES`` (at least ``MIN_ENTRIES``) whose
    block holds ``length`` entries, and its threads, a multiple of 32."""
    for e in ENTRIES:
        if e >= MIN_ENTRIES and (cdiv(length, e) <= (MAX_THREADS if e <= 2 else MAX_THREADS // 2) or e == ENTRIES[-1]):
            return e, cdiv(cdiv(length, e), 32) * 32
    raise AssertionError("unreachable")


def _symmetric_toeplitz(vector: Tensor) -> Tensor:
    """The symmetric Toeplitz matrices ``(..., L, L)`` of first rows ``(..., L)``."""
    length = vector.shape[-1]
    idx = torch.arange(length, device=vector.device)
    return vector[..., (idx[:, None] - idx[None, :]).abs()]


def _sdr_toeplitz_plain(r_0: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch :func:`sdr_toeplitz`: JAX's build, ``solve`` and coherence, in the inputs' dtype."""
    # a singular system (a silent target: r_0 all zero) gives NaN in its row, as jnp.linalg.solve does
    sol, info = torch.linalg.solve_ex(_symmetric_toeplitz(r_0), b[..., None])
    sol = torch.where(info[..., None] == 0, sol[..., 0], torch.nan)
    coh = torch.einsum("...l,...l->...", b, sol)
    return 10.0 * torch.log10(coh / (1 - coh)), sol


def sdr_toeplitz(r_0: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    """Each row's SDR ``(R,)`` and the solution ``x`` ``(R, L)``, both float32, by the CUDA kernel.

    ``chip_smoke.py`` holds it against :func:`_sdr_toeplitz_plain` and the
    same in float64 on the card.

    Args:
        r_0, b: float32 ``(R, L)``, L from 1 to ``MAX_LENGTH``, contiguous, on
            one CUDA device.

    Every check raises ``ValueError`` before anything is built or launched; a
    CUDA error of the launch raises ``RuntimeError``. An empty batch launches
    nothing.
    """
    for name, v in (("r_0", r_0), ("b", b)):
        if v.dtype != torch.float32:
            raise ValueError(f"sdr_toeplitz takes float32 `{name}`, got {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"sdr_toeplitz: `{name}` must be contiguous")
    if r_0.shape != b.shape or r_0.ndim != 2:
        raise ValueError(f"sdr_toeplitz takes (R, L) r_0 and b of one shape, got {tuple(r_0.shape)} and "
                         f"{tuple(b.shape)}")
    rows, length = r_0.shape
    if not 1 <= length <= MAX_LENGTH or rows > MAX_ROWS:
        raise ValueError(f"sdr_toeplitz takes L from 1 to {MAX_LENGTH} and at most {MAX_ROWS} rows, got L = "
                         f"{length} and {rows} rows")
    device = r_0.device
    if b.device != device:
        raise ValueError(f"sdr_toeplitz: `b` is on {b.device}, expected {device}")
    if device.type != "cuda":
        raise ValueError(f"sdr_toeplitz runs on CUDA tensors only, got them on {device}")
    sdr = torch.empty((rows,), dtype=torch.float32, device=device)
    x = torch.empty((rows, length), dtype=torch.float32, device=device)
    if rows == 0:
        return sdr, x
    args = (r_0.data_ptr(), b.data_ptr(), sdr.data_ptr(), x.data_ptr(), rows, length,
            torch.cuda.current_stream(device).cuda_stream)
    launch_on("sdr_toeplitz", device, _launch_fn(), args)
    sdr_toeplitz.launches += 1
    return sdr, x


sdr_toeplitz.launches = 0
