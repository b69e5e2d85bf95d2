"""Launcher of the ``ssim_window`` CUDA kernel (``csrc/ssim.cu``).

:func:`ssim_window` gives the per-image SSIM of a ``(B, C, H, W)`` float32
batch, and optionally the contrast-sensitivity mean or the full SSIM map, in
one launch: the window applied separably through shared-memory tiles, the
row pass in float32 about each row window's centre pixel, the column pass and
the map in double, the inputs read unpadded once. It counts its launches in
``ssim_window.launches`` and takes CUDA tensors only. Its plain version is
``functional.image.ssim._ssim_update_plain`` (the JAX formulas on
``F.conv2d``), which the dispatch ``_ssim_update`` takes for CPU tensors,
5-D volumes and dtypes other than float32.

:func:`plan` is the launch geometry, kept in Python so that the CPU tests
reach it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import cdiv, launch_on, load_library, zero_tickets

SOURCE = "ssim"
TILE_H, TILE_W, THREADS = 64, 32, 256  # outputs a block (8 warps of 8 rows of 32), threads a block
ROW_STRIDE = TILE_W + 1  # a row of the row moments in shared memory
MAX_TAPS = 63  # the window's widest side: its tile, halo and row moments in 176 KB of shared memory
MAX_PLANES = 65_535  # B * C along grid.z

_launch: Optional[ctypes._CFuncPtr] = None


class Plan(NamedTuple):
    row0: int  # the first output row the grid covers
    col0: int
    rows: int  # output rows the grid covers
    cols: int
    blocks: Tuple[int, int, int]  # (cdiv(cols, 32), cdiv(rows, 64), B * C)
    shared_bytes: int  # the taps, the input tile and its halo (two planes), the five row moments (float32)


@functools.lru_cache(maxsize=256)
def plan(batch: int, channels: int, height: int, width: int, kh: int, kw: int, full: bool) -> Plan:
    """The launch geometry: tiles of 32 x 64 outputs over the interior ``[ph, H - ph) x [pw, W - pw)``
    (every position, when the full map is wanted), one (image, channel) plane a ``blockIdx.z``.

    Shared memory (``csrc/ssim.cu``'s ``shared_bytes_for``): the column taps in
    double, the row taps in float32 (to an even count), the input tile and its
    halo as two float32 planes of ``TILE_H + kh - 1`` rows of an odd stride,
    and the five float32 row moments, rows of ``ROW_STRIDE``.
    """
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    row0, col0 = (0, 0) if full or ph == 0 or pw == 0 else (ph, pw)
    rows, cols = height - 2 * row0, width - 2 * col0
    in_h, in_stride = TILE_H + 2 * ph, (TILE_W + 2 * pw) | 1
    shared = 8 * kh + 4 * ((kw + 1) & ~1) + 4 * 2 * in_h * in_stride + 4 * 5 * in_h * ROW_STRIDE
    return Plan(row0, col0, rows, cols, (cdiv(cols, TILE_W), cdiv(rows, TILE_H), batch * channels), shared)


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).ssim_window_launch
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, f, f, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, f, f, ctypes.c_double, i, p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def ssim_window(preds: Tensor, target: Tensor, taps_h: Tensor, taps_w: Tensor, consts: Union[Tensor, Tuple[float, float]],
                clamp: Optional[Tuple[float, float]] = None, contrast_sensitivity: bool = False,
                full_image: bool = False) -> Tuple[Tensor, Optional[Tensor], Optional[Tensor]]:
    """Per-image SSIM ``(B,)`` float32, the contrast-sensitivity mean ``(B,)`` (or None) and the full
    map ``(B, C, H, W)`` (or None), in one launch.

    ``chip_smoke.py`` holds it against the plain version on the card: per-image
    SSIM and CS within 1e-5 relative, the map within 1e-5 absolute.

    Args:
        preds, target: float32 ``(B, C, H, W)``, contiguous, on one CUDA device.
        taps_h, taps_w: float64 windows along H (``kh`` taps) and W (``kw``), odd, at most ``MAX_TAPS``.
        consts: ``c1``, ``c2``: a float32 ``(2,)`` tensor on the device (a data range reduced there), or
            two floats (rounded to float32).
        clamp: ``(lo, hi)`` to clamp both inputs to as they are read, or None.
        contrast_sensitivity: also the mean of ``upper / lower``.
        full_image: also the SSIM map, the border read through the reflected index.

    Every check raises ``ValueError`` before anything is built or launched; a
    CUDA error of the launch raises ``RuntimeError``.
    """
    if preds.dtype != torch.float32 or target.dtype != torch.float32:
        raise ValueError(f"ssim_window takes float32 images, got {preds.dtype} and {target.dtype}")
    if preds.ndim != 4 or target.shape != preds.shape:
        raise ValueError(f"ssim_window takes (B, C, H, W) preds and target of one shape, got {tuple(preds.shape)} "
                         f"and {tuple(target.shape)}")
    if contrast_sensitivity and full_image:
        raise ValueError("ssim_window: the contrast sensitivity and the full map are exclusive")
    b, c, h, w = preds.shape
    kh, kw = taps_h.numel(), taps_w.numel()
    for name, k in (("taps_h", kh), ("taps_w", kw)):
        if k % 2 == 0 or not 1 <= k <= MAX_TAPS:
            raise ValueError(f"ssim_window: `{name}` must have an odd number of taps, at most {MAX_TAPS}, got {k}")
    if h < kh or w < kw:
        raise ValueError(f"ssim_window: images of {h} x {w} are smaller than the {kh} x {kw} window")
    if b * c > MAX_PLANES or b < 1 or c < 1:
        raise ValueError(f"ssim_window takes 1 to {MAX_PLANES} (image, channel) planes a launch, got {b * c}")
    device = preds.device
    on_device = isinstance(consts, Tensor)
    checked = [("preds", preds, torch.float32), ("target", target, torch.float32),
               ("taps_h", taps_h, torch.float64), ("taps_w", taps_w, torch.float64)]
    for name, x, dtype in checked + ([("consts", consts, torch.float32)] if on_device else []):
        if x.device != device:
            raise ValueError(f"ssim_window: `{name}` is on {x.device}, expected {device}")
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"ssim_window: `{name}` must be contiguous {dtype}")
    if len(consts) != 2:
        raise ValueError("ssim_window: `consts` holds c1 and c2")
    if device.type != "cuda":
        raise ValueError(f"ssim_window runs on CUDA tensors only, got them on {device}")

    g = plan(b, c, h, w, kh, kw, full_image)
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    count = float(c * (h - 2 * ph) * (w - 2 * pw)) if ph > 0 and pw > 0 else 0.0
    out = torch.empty((b,), dtype=torch.float32, device=device)
    cs = torch.empty((b,), dtype=torch.float32, device=device) if contrast_sensitivity else None
    full = torch.empty_like(preds) if full_image else None
    partials = torch.empty((b * c * g.blocks[0] * g.blocks[1] * 2,), dtype=torch.float64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    lo, hi = clamp if clamp is not None else (0.0, 0.0)
    args = (
        preds.data_ptr(), target.data_ptr(), taps_h.data_ptr(), taps_w.data_ptr(),
        consts.data_ptr() if on_device else 0, *((0.0, 0.0) if on_device else (float(consts[0]), float(consts[1]))),
        out.data_ptr(), 0 if cs is None else cs.data_ptr(), 0 if full is None else full.data_ptr(),
        partials.data_ptr(), zero_tickets(device, stream, 1).data_ptr(), b, c, h, w, kh, kw,
        g.row0, g.col0, g.rows, g.cols, int(clamp is not None), float(lo), float(hi), count, g.shared_bytes, stream,
    )
    launch_on("ssim_window", device, _launch_fn(), args)
    ssim_window.launches += 1
    return out, cs, full


ssim_window.launches = 0
