"""Launcher of the ``confmat_multiclass`` CUDA kernel (``csrc/confmat.cu``) and its plain version.

:func:`confmat_multiclass` is the fused multiclass confusion-matrix state
update: ``state[t, p] += 1`` for every element of the batch, where ``p`` is
the argmax of the element's scores over dim 1 (or its integer label) and
``t`` its target, in place, in one call into the library. It counts its
launches in ``confmat_multiclass.launches`` and takes CUDA tensors only.
:func:`_confmat_multiclass_plain` is the same update in plain PyTorch, on
any device. The dispatch by the device of the state is
``functional.classification.confusion_matrix._multiclass_confmat_accumulate``.

The pair rule is the JAX package's ``.at[t * C + p].add`` in int32: a flat
index in ``[-C*C, 0)`` wraps to ``index + C*C`` and one below ``-C*C`` or at
``C*C`` and above is dropped, so an out-of-range target or label can count
in another row; an element whose target equals ``ignore_index`` adds
nothing. The argmax is ``jnp.argmax``'s: the lowest index among the maxima,
the first NaN above every number, ``-0.0`` equal to ``+0.0``.

:func:`plan` is the launch geometry, kept in Python so that the CPU tests
reach it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import cdiv, launch_on, load_library, sm_count

SOURCE = "confmat"
MAX_INT32 = 2**31 - 1  # the kernel's cells, elements and flat indices are int32
SHARED_CELLS = 8192  # a block keeps its own (C, C) histogram in shared memory up to 32 KB
ROW_MIN_SCORES = 32  # a warp a row from this many scores a row (one score a lane or more)
ROW_THREADS, ELEMENT_THREADS = 128, 256
ROW_BLOCKS_PER_SM, ELEMENT_BLOCKS_PER_SM = 16, 8

# the codes of csrc/confmat.cu
PRED_KINDS = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2, torch.int32: 3, torch.int64: 4}
TARGET_KINDS = {torch.int32: 0, torch.int64: 1}
MODES = {"rows": 0, "elements": 1, "labels": 2}

_launch: Optional[ctypes._CFuncPtr] = None


class Plan(NamedTuple):
    mode: str  # "rows": a warp a row of scores; "elements": a thread an element walking its scores; "labels"
    shared: bool  # a (C, C) histogram a block in shared memory, flushed once; else int32 atomics on the state
    blocks: int
    threads: int


@functools.lru_cache(maxsize=256)
def plan(n_elements: int, n_scores: int, inner: int, n_classes: int, labels: bool, sm_count: int) -> Plan:
    """The launch geometry for ``n_elements`` (N times the spatial size ``inner``)
    elements of ``n_scores`` scores each (``labels``: integer predictions)."""
    shared = n_classes * n_classes <= SHARED_CELLS
    if not labels and inner == 1 and n_scores >= ROW_MIN_SCORES:
        blocks = min(cdiv(n_elements, ROW_THREADS // 32), ROW_BLOCKS_PER_SM * sm_count)
        return Plan("rows", shared, max(blocks, 1), ROW_THREADS)
    blocks = min(cdiv(n_elements, ELEMENT_THREADS), ELEMENT_BLOCKS_PER_SM * sm_count)
    return Plan("labels" if labels else "elements", shared, max(blocks, 1), ELEMENT_THREADS)


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).confmat_multiclass_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,  # preds, target, state
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # rows, scores, inner, classes
            ctypes.c_int, ctypes.c_longlong,  # has_ignore, ignore_index
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # mode, shared, blocks, threads
        ]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _layout(state: Tensor, preds: Tensor, target: Tensor) -> tuple:
    """``(N, scores an element, inner size)`` of a batch, checked against the state's ``(C, C)``."""
    if state.ndim != 2 or state.shape[0] != state.shape[1] or state.shape[0] < 1:
        raise ValueError(f"confmat_multiclass: `state` must be (C, C), got shape {tuple(state.shape)}")
    if preds.is_floating_point():
        if preds.ndim < 2 or preds.shape[0] != target.shape[0] or preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                f"confmat_multiclass: scores of shape {tuple(preds.shape)} need a target of shape "
                f"(N, *S) = {(preds.shape[0], *preds.shape[2:])}, got {tuple(target.shape)}"
            )
        return preds.shape[0], preds.shape[1], math.prod(preds.shape[2:])
    if preds.shape != target.shape:
        raise ValueError(
            f"confmat_multiclass: labels of shape {tuple(preds.shape)} need a target of the same shape, "
            f"got {tuple(target.shape)}"
        )
    n = preds.shape[0] if preds.ndim else 1
    return n, 1, preds.numel() // max(n, 1)


def _argmax_first(scores: Tensor) -> Tensor:
    """``jnp.argmax(scores, axis=1)``: the first NaN, else the lowest index of the maximum."""
    scores = scores.to(torch.float32)
    nan = scores.isnan()
    first_nan = nan.to(torch.int8).argmax(1)  # torch.argmax gives the first of equal maxima
    finite = scores.masked_fill(nan, -math.inf)
    first_max = (finite == finite.amax(1, keepdim=True)).to(torch.int8).argmax(1)
    return torch.where(nan.any(1), first_nan, first_max)


def _pair_counts(target: Tensor, pred: Tensor, keep: Tensor, n_classes: int) -> Tensor:
    """int32 ``(C, C)`` counts of the kept ``(target, pred)`` pairs at ``int32(t * C + p)``,
    wrapped and dropped as JAX's ``.at[...].add`` does. Any device; no host sync."""
    cells = n_classes * n_classes
    flat = target.reshape(-1).to(torch.int32).to(torch.int64) * n_classes + pred.reshape(-1).to(torch.int32)
    flat = (flat + 2**31) % 2**32 - 2**31  # int32 wrap of the product and the sum
    flat = torch.where(flat < 0, flat + cells, flat)
    keep = keep.reshape(-1) & (flat >= 0) & (flat < cells)
    flat = torch.where(keep, flat, cells)  # a spare cell for what is dropped
    ones = torch.ones_like(flat, dtype=torch.int32)
    counts = torch.zeros(cells + 1, dtype=torch.int32, device=flat.device).index_add_(0, flat, ones)
    return counts[:cells].view(n_classes, n_classes)


def _confmat_multiclass_plain(state: Tensor, preds: Tensor, target: Tensor, ignore_index: Optional[int]) -> Tensor:
    """Plain PyTorch :func:`confmat_multiclass`: ``state`` plus this batch's pair counts, in place."""
    n_classes = state.shape[0]
    pred = _argmax_first(preds) if preds.is_floating_point() else preds
    t32 = target.to(torch.int32)
    keep = torch.ones_like(t32, dtype=torch.bool) if ignore_index is None else t32.to(torch.int64) != ignore_index
    return state.add_(_pair_counts(t32, pred, keep, n_classes))


def confmat_multiclass(state: Tensor, preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tensor:
    """``state`` plus this batch's ``(target, argmax)`` pair counts, in place, by the CUDA kernel.

    ``chip_smoke.py`` holds it equal (``torch.equal``) to
    :func:`_confmat_multiclass_plain` on the card.

    Args:
        state: ``(C, C)`` int32, rows the target, columns the prediction;
            updated in place and returned.
        preds: float32, float16 or bfloat16 scores ``(N, K, *S)``, the
            class on dim 1 (compared after widening to float32), or int32 or
            int64 labels ``(N, *S)``.
        target: int32 or int64 labels ``(N, *S)``; an int64 label counts as
            its low 32 bits, as in the JAX package's int32.
        ignore_index: elements whose target equals it add nothing.

    Every check raises ``ValueError`` before anything is built or launched; a
    CUDA error of the launch raises ``RuntimeError``. An empty batch launches
    nothing.
    """
    if preds.dtype not in PRED_KINDS:
        raise ValueError(f"confmat_multiclass takes preds of {sorted(map(str, PRED_KINDS))}, got {preds.dtype}")
    if target.dtype not in TARGET_KINDS:
        raise ValueError(f"confmat_multiclass takes int32 or int64 targets, got {target.dtype}")
    if state.dtype != torch.int32:
        raise ValueError(f"confmat_multiclass: `state` has dtype {state.dtype}, expected torch.int32")
    n_rows, n_scores, inner = _layout(state, preds, target)
    n_classes = state.shape[0]
    if n_scores < 1:
        raise ValueError("confmat_multiclass needs at least one score an element")
    if n_classes * n_classes > MAX_INT32:
        raise ValueError(f"confmat_multiclass takes C*C below 2**31, got C={n_classes}")
    n_elements = n_rows * inner
    if n_elements > MAX_INT32 or n_rows > MAX_INT32:
        raise ValueError(f"confmat_multiclass takes fewer than 2**31 elements a launch, got {n_elements}")
    device = state.device
    for name, x in (("state", state), ("preds", preds), ("target", target)):
        if x.device != device:
            raise ValueError(f"confmat_multiclass: `{name}` is on {x.device}, expected {device}")
        if not x.is_contiguous():
            raise ValueError(f"confmat_multiclass: `{name}` must be contiguous")
    if device.type != "cuda":
        raise ValueError(f"confmat_multiclass runs on CUDA tensors only, got them on {device}")
    if ignore_index is not None and not -(2**63) <= ignore_index < 2**63:
        raise ValueError(f"confmat_multiclass: ignore_index {ignore_index} is outside int64")
    if n_elements == 0:
        return state

    labels = not preds.is_floating_point()
    geometry = plan(n_elements, n_scores, inner, n_classes, labels, sm_count(device))
    args = (
        preds.data_ptr(), PRED_KINDS[preds.dtype], target.data_ptr(), TARGET_KINDS[target.dtype], state.data_ptr(),
        n_rows, n_scores, inner, n_classes, int(ignore_index is not None), int(ignore_index or 0),
        MODES[geometry.mode], int(geometry.shared), geometry.blocks, geometry.threads,
        torch.cuda.current_stream(device).cuda_stream,
    )
    launch_on("confmat_multiclass", device, _launch_fn(), args)
    confmat_multiclass.launches += 1
    return state


confmat_multiclass.launches = 0
