"""Launcher of the ``poly_mmd`` CUDA kernel (``csrc/poly_mmd.cu``) and its plain version.

:func:`poly_mmd` gives KID's unbiased polynomial-kernel MMD^2 of every subset
``(S,)`` in one launch, the subsets' rows read by index from the real and
fake feature matrices: no gathered copy and no ``m x m`` kernel matrix. It
counts its launches in ``poly_mmd.launches`` and takes CUDA tensors only.
:func:`_poly_mmd_plain` is the JAX package's form in plain PyTorch
(:func:`poly_kernel` three times and :func:`maximum_mean_discrepancy` a
subset, float32); :func:`poly_mmd_subsets` is the dispatch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import check_tensor, launch_on, load_library, zero_scratch, zero_tickets
from torchmetrics_tpu_torch.kernels.pairwise import _integer_pow
from torchmetrics_tpu_torch.utilities.precision import full_float32

SOURCE = "poly_mmd"
CONSUMERS = 256  # kConsumers: two warpgroups of products
PRODUCERS = 256  # kProducers: two warpgroups of loads and splits
THREADS = CONSUMERS + PRODUCERS
ROWS = 128  # kRows: a tile's rows, 64 a consumer warpgroup (wgmma's M)
COLS = 128  # kCols: a tile's columns (wgmma's N)
CHUNK = 32  # kChunk: features a step, a 128-byte row
STAGES = 4  # kStages: the ring's slots, each a chunk's columns split: hi, then lo
PROMOTE = 2  # kPromote: chunks between moves of the accumulators into float32 sums
ALIGN = 8 * CHUNK * 4  # kAlign: the 128-byte swizzle's atom of 8 rows
SHARED_BYTES = ALIGN + STAGES * 2 * COLS * CHUNK * 4  # the launch's dynamic shared memory
MAX_SUBSETS = 65_535  # grid.y
MAX_INT32 = 2**31 - 1

_launch: Optional[ctypes._CFuncPtr] = None


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).poly_mmd_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, ctypes.c_float, ctypes.c_float, p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def tiles(m: int) -> tuple:
    """The row and column tiles of an ``m x m`` matrix: ``ROWS`` and ``COLS`` wide."""
    return -(-m // ROWS), -(-m // COLS)


def first_col_tile(i: int) -> int:
    """``first_col_tile``: the first column tile of row tile ``i`` that holds an entry i < j."""
    return (i * ROWS + 1) // COLS


def blocks(m: int) -> int:
    """Blocks a subset: the ``ROWS x COLS`` tiles of the xy matrix, then those of the upper triangles of xx and
    yy (row tile ``I`` with the column tiles from ``first_col_tile(I)`` on)."""
    tr, tc = tiles(m)
    return tr * tc + 2 * sum(tc - first_col_tile(i) for i in range(tr))


def poly_kernel(f1: Tensor, f2: Tensor, degree: int = 3, gamma: Optional[float] = None, coef: float = 1.0) -> Tensor:
    """``(f1 @ f2.T * gamma + coef) ** degree`` in float32 (TF32 off; ``gamma`` 1 / d by default)."""
    if gamma is None:
        gamma = 1.0 / f1.shape[1]
    with full_float32():
        prod = f1 @ f2.T
    return _integer_pow(prod * gamma + coef, degree)


def maximum_mean_discrepancy(k_xx: Tensor, k_xy: Tensor, k_yy: Tensor) -> Tensor:
    """The unbiased MMD^2 of three kernel matrices (the last two dims; leading dims batch)."""
    m = k_xx.shape[-1]
    kt_xx_sum = (k_xx.sum(dim=-1) - torch.diagonal(k_xx, dim1=-2, dim2=-1)).sum(dim=-1)
    kt_yy_sum = (k_yy.sum(dim=-1) - torch.diagonal(k_yy, dim1=-2, dim2=-1)).sum(dim=-1)
    k_xy_sum = k_xy.sum(dim=(-2, -1))
    value = (kt_xx_sum + kt_yy_sum) / (m * (m - 1))
    return value - 2 * k_xy_sum / (m**2)


def _poly_mmd_plain(x: Tensor, y: Tensor, ix: Tensor, iy: Tensor, degree: int, gamma: float, coef: float) -> Tensor:
    """Plain PyTorch :func:`poly_mmd`: a subset at a time, its rows gathered, the three kernel matrices and their
    sums in float32."""
    values = []
    for rows_x, rows_y in zip(ix, iy):
        xs, ys = x[rows_x], y[rows_y]
        values.append(maximum_mean_discrepancy(poly_kernel(xs, xs, degree, gamma, coef),
                                               poly_kernel(xs, ys, degree, gamma, coef),
                                               poly_kernel(ys, ys, degree, gamma, coef)))
    return torch.stack(values) if values else x.new_zeros((0,))


def poly_mmd(x: Tensor, y: Tensor, ix: Tensor, iy: Tensor, degree: int, gamma: float, coef: float) -> Tensor:
    """``(S,)`` float32 unbiased MMD^2 of the subsets ``x[ix[s]]``, ``y[iy[s]]``, by the CUDA kernel.

    The products run on the tensor cores in three TF32 passes (``lo.hi + hi.lo + hi.hi``); a product that comes
    out inf or NaN is taken again in float32. ``chip_smoke.py`` holds it against :func:`_poly_mmd_plain` on the
    card within 1e-5 of the terms' scale, ``(|kt_xx| + |kt_yy|) / (m (m - 1)) + 2 |k_xy| / m^2`` (the MMD
    cancels: a relative bound would not hold), and against a float64 evaluation within 1e-7 of it, NaN where the
    plain version is NaN.

    Args:
        x, y: float32 ``(N_r, d)`` and ``(N_f, d)``, contiguous, on one CUDA device.
        ix, iy: int64 ``(S, m)`` row indices into ``x`` and ``y``, ``S`` up to 65,535, ``m >= 2``.
        degree: the polynomial's degree, a positive int.
        gamma, coef: the kernel's scale and offset (taken in float32).

    Every check raises ``ValueError`` before anything is built or launched; a CUDA error of the launch raises
    ``RuntimeError``.
    """
    if isinstance(degree, bool) or not isinstance(degree, int) or not 1 <= degree <= MAX_INT32:
        raise ValueError(f"poly_mmd takes a positive int degree, got {degree!r}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1] or ix.ndim != 2 or ix.shape != iy.shape:
        raise ValueError(f"poly_mmd takes x (N_r, d), y (N_f, d) and indices (S, m), got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}, {tuple(ix.shape)} and {tuple(iy.shape)}")
    (subsets, m), d = ix.shape, x.shape[1]
    if not 1 <= subsets <= MAX_SUBSETS or m < 2 or d < 1 or d > MAX_INT32 or blocks(m) > MAX_INT32:
        raise ValueError(f"poly_mmd takes 1 to {MAX_SUBSETS} subsets of at least 2 rows of width >= 1, "
                         f"got {subsets} of {m} rows, d = {d}")
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"poly_mmd runs on CUDA tensors only, got them on {device}")
    check_tensor("poly_mmd", "x", x, torch.float32, tuple(x.shape), device)
    check_tensor("poly_mmd", "y", y, torch.float32, tuple(y.shape), device)
    check_tensor("poly_mmd", "ix", ix, torch.int64, (subsets, m), device)
    check_tensor("poly_mmd", "iy", iy, torch.int64, (subsets, m), device)
    out = torch.empty(subsets, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    sums = zero_scratch(device, stream, "poly_mmd_sums", 24 * subsets)
    tickets = zero_tickets(device, stream, subsets)
    args = (x.data_ptr(), y.data_ptr(), ix.data_ptr(), iy.data_ptr(), out.data_ptr(), sums.data_ptr(),
            tickets.data_ptr(), subsets, m, d, degree, float(gamma), float(coef), stream)
    launch_on("poly_mmd", device, _launch_fn(), args)
    poly_mmd.launches += 1
    return out


poly_mmd.launches = 0


def _on_kernel(*xs: Tensor) -> bool:
    """Float32 tensors on the card that need no grad: the kernel's inputs."""
    return all(x.device.type == "cuda" and x.dtype == torch.float32 and not x.requires_grad for x in xs)


def poly_mmd_subsets(x: Tensor, y: Tensor, ix: Tensor, iy: Tensor, degree: int, gamma: float, coef: float) -> Tensor:
    """The subsets' MMD^2: the CUDA kernel for float32 features on the card that need no grad, the plain
    version for anything else (another dtype, grad, the CPU)."""
    if _on_kernel(x, y):
        return poly_mmd(x.contiguous(), y.contiguous(), ix.to(torch.int64).contiguous(),
                        iy.to(torch.int64).contiguous(), degree, gamma, coef)
    return _poly_mmd_plain(x, y, ix, iy, degree, gamma, coef)
