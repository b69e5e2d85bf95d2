"""Launcher of the ``pairwise_lp`` CUDA kernel (``csrc/pairwise.cu``) and its plain version.

:func:`pairwise_lp` gives the ``(N, M)`` L_p distance matrix of ``x (N, d)``
and ``y (M, d)`` float32 in one launch, tiled so that no ``(N, M, d)``
temporary exists. It counts its launches in ``pairwise_lp.launches`` and takes
CUDA tensors only. :func:`_pairwise_lp_plain` is the JAX package's broadcast
form in plain PyTorch; :func:`pairwise_lp_distance` is the dispatch by device.

The arithmetic is JAX's: a Python ``int`` exponent is ``lax.integer_pow``
(binary exponentiation, :func:`_integer_pow`), a ``float`` one ``lax.pow``;
the root is ``pow(s, float32(1 / p))``, or none (the Manhattan distance), or
a square root (``jnp.linalg.norm``, the cluster scores' centroid distances).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import cdiv, check_tensor, launch_on, load_library, sm_count

SOURCE = "pairwise"
THREADS = 256  # kThreads
COL_THREADS = 16  # kColThreads: threads across a block's columns
ROW_THREADS = THREADS // COL_THREADS  # kRowThreads
TILES = ((8, 8), (4, 4))  # a thread's sums, rows x columns: output tiles of 128 x 128 or 64 x 64
CHUNK = 32  # kChunk: columns of x and y staged a step
MAX_COLS = 65_535 * COL_THREADS * 8  # column tiles along grid.y (64 x 64 tiles only below 2 blocks an SM at 128)
MAX_INT32 = 2**31 - 1
PLAIN_BLOCK_ELEMENTS = 2**26  # the plain version's broadcast a block of rows at a time: 256 MB of float32

# the codes of csrc/pairwise.cu
KINDS = {"abs": 0, "square": 1, "integer_pow": 2, "pow": 3}
ROOTS = {None: 0, "pow": 1, "sqrt": 2}

_launch: Optional[ctypes._CFuncPtr] = None


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).pairwise_lp_launch
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, i, i, i, i, i, f, i, f, i, i, p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def tile(n: int, m: int, p: Union[int, float], sms: int) -> Tuple[int, int]:
    """A thread's sums, rows x columns: 8 x 8 (128 x 128 output tiles) for an integer ``p`` where those give every
    SM two blocks, else 4 x 4 (64 x 64 tiles): a 1,024 x 1,024 matrix takes 256 blocks and not 64, and a float
    ``p``'s batches of terms keep the registers that a wider tile would take."""
    if isinstance(p, float) or cdiv(n, ROW_THREADS * 8) * cdiv(m, COL_THREADS * 8) < 2 * sms:
        return 4, 4
    return 8, 8


def _integer_pow(x: Tensor, n: int) -> Tensor:
    """``lax.integer_pow(x, n)``, ``n >= 1``: binary exponentiation, ``x ** 3 = x * (x * x)``."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _power(x: Tensor, p: Union[int, float]) -> Tensor:
    """``x ** p`` as JAX lowers it: ``integer_pow`` for an ``int``, ``pow`` for a ``float``."""
    return _integer_pow(x, p) if isinstance(p, int) else torch.pow(x, float(p))


def _kind(p: Union[int, float]) -> str:
    if isinstance(p, int):
        return {1: "abs", 2: "square"}.get(p, "integer_pow")
    return "pow"


def _pairwise_lp_plain(x: Tensor, y: Tensor, p: Union[int, float], root: Optional[str]) -> Tensor:
    """Plain PyTorch :func:`pairwise_lp`: JAX's ``(N, M, d)`` broadcast, summed over ``d``, taken a block of
    rows of ``x`` at a time (each pair's sum is the same; the temporary stays near ``PLAIN_BLOCK_ELEMENTS``)."""
    rows = max(1, PLAIN_BLOCK_ELEMENTS // max(1, y.shape[0] * x.shape[1]))
    s = torch.cat([_power((xb[:, None, :] - y[None, :, :]).abs(), p).sum(-1) for xb in x.split(rows)]) \
        if x.shape[0] else x.new_zeros((0, y.shape[0]))
    if root == "pow":
        return torch.pow(s, torch.tensor(1.0 / p, dtype=torch.float32).item())
    return s.sqrt() if root == "sqrt" else s


def pairwise_lp(x: Tensor, y: Tensor, p: Union[int, float], root: Optional[str]) -> Tensor:
    """``(N, M)`` float32 ``root(sum_k |x_ik - y_jk| ** p)``, by the CUDA kernel.

    ``chip_smoke.py`` holds it against :func:`_pairwise_lp_plain` on the card:
    within 1e-6 relative plus the float32 summation bound of the plain
    version's ``d`` terms.

    Args:
        x, y: float32 ``(N, d)`` and ``(M, d)``, contiguous, on one CUDA device.
        p: a positive ``int`` (``lax.integer_pow``) or ``float`` (``lax.pow``).
        root: None, ``"pow"`` (``s ** float32(1 / p)``) or ``"sqrt"``.

    Every check raises ``ValueError`` before anything is built or launched; a
    CUDA error of the launch raises ``RuntimeError``. An empty ``x`` or ``y``
    launches nothing.
    """
    if isinstance(p, bool) or not isinstance(p, (int, float)) or not p > 0:
        raise ValueError(f"pairwise_lp takes a positive int or float exponent, got {p!r}")
    if isinstance(p, int) and p > MAX_INT32:
        raise ValueError(f"pairwise_lp takes an int exponent below 2**31, got {p}")
    if root not in ROOTS:
        raise ValueError(f"pairwise_lp: `root` must be one of {sorted(ROOTS, key=str)}, got {root!r}")
    if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"pairwise_lp takes x (N, d) and y (M, d), got {tuple(x.shape)} and {tuple(y.shape)}")
    (n, d), m = x.shape, y.shape[0]
    if m > MAX_COLS or n > MAX_INT32 or d > MAX_INT32 or max(n, m) * max(d, 1) > 2**62:
        raise ValueError(f"pairwise_lp takes at most {MAX_COLS} rows of y, got {m}")
    device = x.device
    check_tensor("pairwise_lp", "x", x, torch.float32, (n, d), device)
    check_tensor("pairwise_lp", "y", y, torch.float32, (m, d), device)
    if device.type != "cuda":
        raise ValueError(f"pairwise_lp runs on CUDA tensors only, got them on {device}")
    out = torch.empty((n, m), dtype=torch.float32, device=device)
    if n == 0 or m == 0:
        return out
    inv_p = torch.tensor(1.0 / p, dtype=torch.float32).item()  # JAX's weakly typed 1.0 / p, in float32
    args = (x.data_ptr(), y.data_ptr(), out.data_ptr(), n, m, d, KINDS[_kind(p)], int(p) if isinstance(p, int) else 0,
            float(p), ROOTS[root], inv_p, *tile(n, m, p, sm_count(device)),
            torch.cuda.current_stream(device).cuda_stream)
    launch_on("pairwise_lp", device, _launch_fn(), args)
    pairwise_lp.launches += 1
    return out


pairwise_lp.launches = 0


def pairwise_lp_distance(x: Tensor, y: Tensor, p: Union[int, float], root: Optional[str]) -> Tensor:
    """The L_p distance matrix: the CUDA kernel for tensors on the card, its plain version on the CPU."""
    x, y = x.contiguous(), y.contiguous()
    if x.device.type == "cpu":
        return _pairwise_lp_plain(x, y, p, root)
    return pairwise_lp(x, y, p, root)
