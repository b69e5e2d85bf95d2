"""Launchers of the int8 chunk codec's CUDA kernels (``csrc/int8_codec.cu``) and their plain versions.

The compressed bucket syncs (:mod:`torchmetrics_tpu_torch.parallel.compress`)
move a float32 bucket as int8 codes with one float32 scale a chunk of
``chunk`` values, packed per row as ``[int8 payload | float32 scales]``:

* :func:`int8_quantize` packs a float32 ``(rows, n_chunks * chunk)`` tensor
  into uint8 ``(rows, n_chunks * (chunk + 4))``, one launch;
* :func:`int8_dequant_sum` reads ``k`` packed rows and, in ``"sum"`` mode,
  adds their values ``q * scale`` in float32 in row order, and with
  ``requantize=True`` packs the sums again in the same launch (the int8
  all-reduce's phase 2); in ``"concat"`` mode it writes each row's values to
  their slot (the final unpack).

The sum is JAX's as XLA compiles it on the CPU: the jitted ``stack(...).sum(0)``
of products becomes ``fma(q0, s0, q1 * s1)``, then ``fma(qj, sj, acc)`` for
``j = 2 .. k-1`` (LLVM contracts each add with its product; one row is just
its product); the host path (``host=True``, numpy's ``sum`` of dequantized
rows) adds the rounded products into 0.0 one after the other.

Per chunk: ``amax = max |x|`` (NaN if any entry is NaN), ``scale = amax *
float32(1/127)`` if ``amax > 0`` else 1, ``q = clip(rint(x / scale), -127,
127)`` with a NaN quotient mapped to 0, as XLA's float-to-int8 conversion maps
it on the CPU (a NaN chunk keeps scale 1; an infinite one has scale inf, so
its finite entries code 0 and its infinities NaN, hence 0). The scale is
JAX's: inside its jitted sync XLA multiplies by the reciprocal of the
constant 127, while its host path (``host_quantize_int8``, numpy) divides,
which ``host_scale=True`` selects. ``x / scale`` is an IEEE division in both
and ``rint`` rounds half to even. Subnormals are kept as IEEE arithmetic
keeps them; XLA on the CPU flushes them to zero (a kept divergence that only
a chunk of subnormals shows).

``_int8_quantize_plain`` and ``_int8_dequant_sum_plain`` are the JAX
package's ``_quantize_chunks``/``_dequantize_chunks`` and the fp32 sum of
``psum_int8`` in plain PyTorch; the CPU takes them. The kernels equal them
bit for bit (``chip_smoke.py`` holds them with ``torch.equal`` on the card):
the plain version divides tensor by tensor (a CUDA division by a Python
scalar multiplies by its reciprocal) and adds the rows one after the other.
Each launcher counts its launches in ``.launches`` and takes CUDA tensors
only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import check_tensor, launch_on, load_library

SOURCE = "int8_codec"
THREADS = 256  # kThreads: 8 warps a block, a warp a chunk
SCALE_BYTES = 4
MIN_CHUNK = 8
MODES = ("sum", "concat")
#: float32(1/127): the factor XLA's jitted graph scales a chunk's maximum by
RCP_LEVELS = float(torch.tensor(1.0, dtype=torch.float32) / torch.tensor(127.0, dtype=torch.float32))

_quantize_fn: Optional[ctypes._CFuncPtr] = None
_dequant_fn: Optional[ctypes._CFuncPtr] = None


def packed_width(n_chunks: int, chunk: int) -> int:
    """Bytes of one packed row of ``n_chunks`` chunks."""
    return n_chunks * (chunk + SCALE_BYTES)


def _n_chunks(packed: Tensor, chunk: int) -> int:
    width = packed.shape[-1]
    if width % (chunk + SCALE_BYTES):
        raise ValueError(f"a packed row of {width} bytes does not hold whole chunks of {chunk}")
    return width // (chunk + SCALE_BYTES)


def _int8_quantize_plain(x: Tensor, chunk: int, host_scale: bool = False) -> Tensor:
    """Plain PyTorch :func:`int8_quantize`: JAX's ``_quantize_chunks`` as its jitted sync computes it on each
    row (``host_scale=True``: as ``host_quantize_int8`` does)."""
    rows = x.shape[0]
    xc = x.reshape(rows, -1, chunk)
    amax = xc.abs().amax(-1)  # propagates a NaN
    if host_scale:
        scaled = amax / torch.full_like(amax, 127.0)
    else:
        scaled = amax * torch.full_like(amax, RCP_LEVELS)
    scale = torch.where(amax > 0, scaled, torch.ones_like(amax))
    r = torch.round(xc / scale[..., None])
    q = torch.where(torch.isnan(r), torch.zeros_like(r), r.clamp(-127.0, 127.0)).to(torch.int8)
    return torch.cat([q.reshape(rows, -1).view(torch.uint8), scale.view(torch.uint8).reshape(rows, -1)], dim=1)


def _fma32(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """``a * b + c`` of float32 tensors rounded once to float32, as a fused multiply-add, in float64: ``a * b``
    is exact there (an int8 code times a float32 scale), the sum's rounding error comes from TwoSum, and a
    sum that rounds to a float32 midpoint goes the way its error points."""
    p, cd = a.double() * b.double(), c.double()
    t = p + cd
    bp = t - cd
    err = (p - bp) + (cd - (t - bp))
    r = t.to(torch.float32)
    diff = t - r.double()
    toward = torch.nextafter(r, torch.where(diff > 0, torch.full_like(r, float("inf")), torch.full_like(r, -float("inf"))))
    midpoint = (diff != 0) & (2 * diff == toward.double() - r.double())
    push = midpoint & (err != 0) & ((err > 0) == (diff > 0)) & torch.isfinite(t)
    return torch.where(push, toward, r)


def _int8_dequant_sum_plain(packed: Tensor, chunk: int, mode: str = "sum", requantize: bool = False,
                            host: bool = False) -> Tensor:
    """Plain PyTorch :func:`int8_dequant_sum`: JAX's ``_dequantize_chunks`` of each row, then the rows' sum in
    JAX's order (``host=True``: the host path's) or the rows side by side."""
    k = packed.shape[0]
    n_chunks = _n_chunks(packed, chunk)
    width = n_chunks * chunk
    q = packed[:, :width].view(torch.int8).reshape(k, n_chunks, chunk).to(torch.float32)
    scale = packed[:, width:].reshape(-1).clone().view(torch.float32)  # a dense copy: a row's scales may sit unaligned
    scale = scale.reshape(k, n_chunks)[..., None].expand(k, n_chunks, chunk)
    if mode == "concat":
        return (q * scale).reshape(-1)
    if host:
        acc = torch.zeros_like(q[0])
        for j in range(k):
            acc = acc + q[j] * scale[j]
    elif k == 1:
        acc = q[0] * scale[0]
    else:
        acc = _fma32(q[0], scale[0], q[1] * scale[1])
        for j in range(2, k):
            acc = _fma32(q[j], scale[j], acc)
    return _int8_quantize_plain(acc.reshape(1, -1), chunk)[0] if requantize else acc.reshape(-1)


def _check(chunk: int, mode: str = "sum", requantize: bool = False) -> None:
    if not isinstance(chunk, int) or chunk < MIN_CHUNK:
        raise ValueError(f"the int8 codec needs an int chunk >= {MIN_CHUNK}, got {chunk!r}")
    if mode not in MODES:
        raise ValueError(f"int8_dequant_sum mode must be one of {MODES}, got {mode!r}")
    if mode == "concat" and requantize:
        raise ValueError("int8_dequant_sum requantizes sums only: mode='concat' takes requantize=False")


def int8_quantize(x: Tensor, chunk: int, host_scale: bool = False) -> Tensor:
    """Pack float32 ``(rows, n_chunks * chunk)`` into uint8 ``(rows, n_chunks * (chunk + 4))`` by the CUDA kernel;
    ``host_scale=True`` divides the chunk's maximum by 127 as the host path does.

    Every check raises ``ValueError`` before anything is built or launched; a
    CUDA error of the launch raises ``RuntimeError``.
    """
    _check(chunk)
    device = x.device
    if x.ndim != 2 or x.shape[1] % chunk:
        raise ValueError(f"int8_quantize takes (rows, n_chunks * {chunk}) float32, got {tuple(x.shape)}")
    check_tensor("int8_quantize", "x", x, torch.float32, tuple(x.shape), device)
    if device.type != "cuda":
        raise ValueError(f"int8_quantize takes CUDA tensors, got {device}")
    rows, n_chunks = x.shape[0], x.shape[1] // chunk
    out = torch.empty((rows, packed_width(n_chunks, chunk)), dtype=torch.uint8, device=device)
    if rows == 0 or n_chunks == 0:
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (x.data_ptr(), out.data_ptr(), rows, n_chunks, chunk, int(host_scale), stream)
    launch_on("int8_quantize", device, _quantize(), args)
    int8_quantize.launches += 1
    return out


def int8_dequant_sum(packed: Tensor, chunk: int, mode: str = "sum", requantize: bool = False,
                     host: bool = False) -> Tensor:
    """Dequantize ``k`` packed rows by the CUDA kernel: their float32 sum in row order (``"sum"``; packed again
    with ``requantize=True``) or the rows' values side by side (``"concat"``).

    Args:
        packed: uint8 ``(k, n_chunks * (chunk + 4))``, contiguous, on a CUDA device.
        chunk: the values a scale covers (at least 8).
        mode: ``"sum"`` -> float32 ``(n_chunks * chunk,)``, or uint8
            ``(n_chunks * (chunk + 4),)`` when requantized; ``"concat"`` ->
            float32 ``(k * n_chunks * chunk,)``.
        requantize: pack the sums (sum mode only).
        host: the host path's sum (rounded products added into 0.0) instead of the jitted one's.
    """
    _check(chunk, mode, requantize)
    device = packed.device
    if packed.ndim != 2:
        raise ValueError(f"int8_dequant_sum takes (k, packed) uint8, got {tuple(packed.shape)}")
    check_tensor("int8_dequant_sum", "packed", packed, torch.uint8, tuple(packed.shape), device)
    if device.type != "cuda":
        raise ValueError(f"int8_dequant_sum takes CUDA tensors, got {device}")
    k, n_chunks = packed.shape[0], _n_chunks(packed, chunk)
    if k == 0:
        raise ValueError("int8_dequant_sum needs at least one packed row")
    concat = mode == "concat"
    if requantize:
        out = torch.empty((packed_width(n_chunks, chunk),), dtype=torch.uint8, device=device)
    else:
        out = torch.empty(((k if concat else 1) * n_chunks * chunk,), dtype=torch.float32, device=device)
    if n_chunks == 0:
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (packed.data_ptr(), out.data_ptr(), k, n_chunks, chunk, int(concat), int(requantize), int(host), stream)
    launch_on("int8_dequant_sum", device, _dequant(), args)
    int8_dequant_sum.launches += 1
    return out


def _quantize() -> ctypes._CFuncPtr:
    global _quantize_fn
    if _quantize_fn is None:
        fn = load_library(SOURCE).int8_codec_quantize
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, ll, ll, i, i, p]
        fn.restype = ctypes.c_int
        _quantize_fn = fn
    return _quantize_fn


def _dequant() -> ctypes._CFuncPtr:
    global _dequant_fn
    if _dequant_fn is None:
        fn = load_library(SOURCE).int8_codec_dequant_sum
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, i, ll, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _dequant_fn = fn
    return _dequant_fn


int8_quantize.launches = 0
int8_dequant_sum.launches = 0
