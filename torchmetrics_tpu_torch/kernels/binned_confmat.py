"""Launcher of the ``binned_confmat_multiclass`` CUDA kernel (``csrc/binned_confmat.cu``).

:func:`binned_confmat_multiclass` checks its inputs, launches the kernel on
the current stream and counts its launches in
``binned_confmat_multiclass.launches``. It takes CUDA tensors only: the
dispatch between the kernel and its plain PyTorch version, by the device of
the input, is ``functional.classification.precision_recall_curve._binned_confmat_multiclass``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import load_library

SOURCE = "binned_confmat"
_CLASS_TILE = 128  # kClassTile in the source
_THR_TILE = 32  # kThrTile in the source
_BLOCKS_PER_SM = 2  # rows are cut into chunks until the grid has about this many blocks per SM

_sm_count: Dict[int, int] = {}


def _launch_fn() -> ctypes._CFuncPtr:
    fn = load_library(SOURCE).binned_confmat_multiclass_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rows_per_block(device: torch.device, n_rows: int, n_classes: int, n_thr: int) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(index).multi_processor_count
    tiles = -(-n_classes // _CLASS_TILE) * -(-n_thr // _THR_TILE)
    chunks = max(1, -(-_BLOCKS_PER_SM * _sm_count[index] // tiles))
    return max(1, -(-n_rows // chunks))


def _check(name: str, x: Tensor, dtype: torch.dtype, ndim: int, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"binned_confmat_multiclass: `{name}` is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"binned_confmat_multiclass: `{name}` has dtype {x.dtype}, expected {dtype}")
    if x.ndim != ndim:
        raise ValueError(f"binned_confmat_multiclass: `{name}` has {x.ndim} dims, expected {ndim}")
    if not x.is_contiguous():
        raise ValueError(f"binned_confmat_multiclass: `{name}` must be contiguous")


def binned_confmat_multiclass(
    probs: Tensor, target: Tensor, weights: Tensor, thresholds: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """``(tp (T, C), pospred (T, C), actpos (C,))`` float32 counts, by the CUDA kernel.

    Args:
        probs: ``(N, C)`` float32 scores.
        target: ``(N,)`` int32 class labels.
        weights: ``(N,)`` float32 row weights (the 0/1 ignore mask).
        thresholds: ``(T,)`` float32, any order.
    """
    device = probs.device
    if device.type != "cuda":
        raise ValueError(f"binned_confmat_multiclass runs on CUDA tensors only, got one on {device}")
    _check("probs", probs, torch.float32, 2, device)
    _check("target", target, torch.int32, 1, device)
    _check("weights", weights, torch.float32, 1, device)
    _check("thresholds", thresholds, torch.float32, 1, device)
    n_rows, n_classes = probs.shape
    n_thr = thresholds.shape[0]
    if target.shape[0] != n_rows or weights.shape[0] != n_rows:
        raise ValueError(
            f"binned_confmat_multiclass: probs has {n_rows} rows but target has {target.shape[0]} "
            f"and weights {weights.shape[0]}"
        )
    if n_classes < 1 or n_thr < 1:
        raise ValueError("binned_confmat_multiclass needs at least one class and one threshold")
    if n_rows >= 2**24:
        # float32 counts stay exact integers only below 2**24 rows a launch
        raise ValueError(f"binned_confmat_multiclass takes fewer than 2**24 rows a launch, got {n_rows}")

    out = torch.zeros((2 * n_thr + 1, n_classes), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _launch_fn()(
            probs.data_ptr(), target.data_ptr(), weights.data_ptr(), thresholds.data_ptr(), out.data_ptr(),
            n_rows, n_classes, n_thr, _rows_per_block(device, n_rows, n_classes, n_thr),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"binned_confmat_multiclass: kernel launch failed with CUDA error {err}")
    binned_confmat_multiclass.launches += 1
    return out[:n_thr], out[n_thr : 2 * n_thr], out[2 * n_thr]


binned_confmat_multiclass.launches = 0
