"""Compressed collectives for bucketed state syncs (counterpart of ``torchmetrics_tpu/parallel/compress.py``).

The coalescing planner (:mod:`.coalesce`) can attach a compression stage to
a large float32 SUM bucket, to shrink the bytes its collective moves:

``bf16``
    Cast the bucket to bfloat16, one ``all_reduce``, cast back. Half the
    bytes, about ``2**-8`` relative error of the chunk's largest value.

``int8``
    Two-phase quantized all-reduce with one float32 scale a chunk of
    ``chunk`` values: each rank splits the bucket into ``n`` blocks, packs
    each (the ``int8_quantize`` kernel), and one ``all_to_all`` gives rank
    ``k`` every rank's copy of block ``k``; it dequantizes and sums them in
    float32 in rank order and packs the sum again (``int8_dequant_sum``), and
    one ``all_gather`` of the packed sums and their unpack complete the
    all-reduce. Two collectives, about 4x fewer bytes than float32, error
    within two stages of ``1/127`` of the chunk's largest magnitude.

A sharded bucket's reduce-scatter compresses the same way: ``bf16`` is one
``reduce_scatter`` in bfloat16, ``int8`` phase 1 and the sum only (one
quantization stage, one collective).

Only float32 sum buckets at or above ``min_bucket_bytes`` are compressed:
integer, min and max buckets and every passthrough leaf stay exact. Without
a process group the world is one rank and both modes still quantize, as
JAX's one-device ``psum_int8`` does. On a CUDA tensor the int8 codec runs
the hand kernels of :mod:`torchmetrics_tpu_torch.kernels.int8_codec`; on
the CPU their plain versions. The wire-byte models are JAX's integer
arithmetic, unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.reductions import (
    all_gather_rows,
    all_reduce,
    all_to_all_rows,
    reduce_scatter_rows,
    world_size,
)
from torchmetrics_tpu_torch.kernels.int8_codec import (
    _int8_dequant_sum_plain,
    _int8_quantize_plain,
    int8_dequant_sum,
    int8_quantize,
)

__all__ = [
    "COMPRESSION_MODES",
    "CompressionConfig",
    "CompressionSpec",
    "DEFAULT_CHUNK",
    "DEFAULT_MIN_BUCKET_BYTES",
    "PREDICTED_EXACT_INT_LIMIT",
    "PREDICTED_REL_ERROR",
    "predicted_error_bound",
    "predicted_exact_int_limit",
    "SCALE_BYTES",
    "bucket_wire_bytes",
    "compressed_psum",
    "compression_bound_provenance",
    "compression_spec_for",
    "host_compressed_payload_bytes",
    "host_dequantize_int8",
    "host_quantize_int8",
    "int8_block_bytes",
    "psum_bf16",
    "psum_int8",
]

#: one float32 scale a chunk of this many int8 codes
DEFAULT_CHUNK = 256
#: buckets below this many bytes stay exact: the scales and the block padding erase the gain
DEFAULT_MIN_BUCKET_BYTES = 4096
SCALE_BYTES = 4

COMPRESSION_MODES = ("none", "bf16", "int8")

#: declared error bound of one stage, relative to the chunk's largest magnitude; the device int8 path
#: quantizes twice (the senders' blocks, then the summed partial), so its bound is two stages
PREDICTED_REL_ERROR: Dict[str, float] = {
    "bf16": 2.0 ** -8,
    "int8": 2.0 / 127.0,
}

#: largest integer a compressed wire format carries exactly: bf16's 8 mantissa bits; int8 none
PREDICTED_EXACT_INT_LIMIT: Dict[str, float] = {
    "bf16": 2.0 ** 8,
    "int8": 0.0,
}


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """A policy's compression request: ``mode`` ``"bf16"`` or ``"int8"`` (``None`` stands for exact syncs),
    an optional ``error_budget`` a bucket's declared bound must fit, the byte floor and the chunk."""

    mode: str
    error_budget: Optional[float] = None
    min_bucket_bytes: int = DEFAULT_MIN_BUCKET_BYTES
    chunk: int = DEFAULT_CHUNK

    def __post_init__(self) -> None:
        if self.mode not in ("bf16", "int8"):
            raise ValueError(
                f"compression mode must be 'bf16' or 'int8', got {self.mode!r}"
                " (use compression=None / 'none' for exact syncs)"
            )
        if self.error_budget is not None and not self.error_budget > 0:
            raise ValueError(f"error_budget must be positive, got {self.error_budget!r}")
        if self.min_bucket_bytes < 0:
            raise ValueError(f"min_bucket_bytes must be >= 0, got {self.min_bucket_bytes!r}")
        if self.chunk < 8:
            raise ValueError(f"chunk must be >= 8, got {self.chunk!r}")

    @classmethod
    def from_mode(cls, mode: Optional[str], error_budget: Optional[float] = None) -> Optional["CompressionConfig"]:
        """``"none"``/``None`` -> ``None``; otherwise a validated config."""
        if mode is None or mode == "none":
            if error_budget is not None:
                raise ValueError("error_budget requires compression='bf16' or 'int8'")
            return None
        return cls(mode=mode, error_budget=error_budget)


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """One bucket's compression in a ``SyncPlan``; ``error_bound`` is its declared end-to-end bound."""

    mode: str
    chunk: int = DEFAULT_CHUNK
    error_bound: float = 0.0

    @property
    def n_collectives(self) -> int:
        """Collectives the bucket's all-reduce issues (the int8 exchange is two-phase)."""
        return 2 if self.mode == "int8" else 1


def predicted_error_bound(mode: str, *, stages: int = 1) -> float:
    """Declared relative error bound of ``mode`` over ``stages`` stages."""
    return PREDICTED_REL_ERROR[mode] * stages


def predicted_exact_int_limit(mode: str) -> float:
    """Largest integer ``mode`` carries exactly (0: none)."""
    return PREDICTED_EXACT_INT_LIMIT[mode]


def compression_bound_provenance(mode: str, *, budget: Optional[float] = None) -> Dict[str, object]:
    """The declared end-to-end bound of a mode and how it was derived (int8: two stages)."""
    stages = 2 if mode == "int8" else 1
    return {
        "source": "compression",
        "mode": mode,
        "stages": stages,
        "bound": predicted_error_bound(mode, stages=stages),
        "budget": budget,
    }


def compression_spec_for(
    dtype: str, op: str, nbytes: int, config: Optional[CompressionConfig]
) -> Optional[CompressionSpec]:
    """The spec of a planner bucket, or ``None`` where it stays exact: only float32 sum buckets (MEAN leaves
    ride them) at or above the byte floor whose declared bound fits the budget are compressed."""
    if config is None:
        return None
    if op != "sum" or dtype != "float32":
        return None
    if nbytes < config.min_bucket_bytes:
        return None
    stages = 2 if config.mode == "int8" else 1
    bound = predicted_error_bound(config.mode, stages=stages)
    if config.error_budget is not None and bound > config.error_budget:
        return None
    return CompressionSpec(mode=config.mode, chunk=config.chunk, error_bound=bound)


# ---------------------------------------------------------------- the codec
def _quantize_chunks(blocks: Tensor, chunk: int, host_scale: bool = False) -> Tensor:
    """Pack float32 ``(rows, n_chunks * chunk)`` into uint8 rows: the kernel on CUDA, its plain version else."""
    if blocks.is_cuda:
        return int8_quantize(blocks.contiguous(), chunk, host_scale)
    return _int8_quantize_plain(blocks, chunk, host_scale)


def _dequantize_chunks(packed: Tensor, chunk: int, mode: str = "sum", requantize: bool = False,
                       host: bool = False) -> Tensor:
    """Unpack ``k`` packed rows: their sum in rank order, packed again when asked, or the rows side by side."""
    if packed.is_cuda:
        return int8_dequant_sum(packed.contiguous(), chunk, mode, requantize, host)
    return _int8_dequant_sum_plain(packed, chunk, mode, requantize, host)


# ---------------------------------------------------- compressed collectives
def psum_bf16(flat: Tensor) -> Tensor:
    """All-reduce ``flat`` over the ranks with a bfloat16 wire payload."""
    return all_reduce(flat.to(torch.bfloat16), "sum").to(flat.dtype)


def psum_int8(flat: Tensor, chunk: int = DEFAULT_CHUNK) -> Tensor:
    """Two-phase int8 all-reduce with one scale a chunk: ``all_to_all`` of the packed blocks, the sum of this
    rank's block packed again, ``all_gather`` of the packed sums. A world of one rank still quantizes twice."""
    orig_dtype = flat.dtype
    flat = flat.to(torch.float32)
    n = world_size()
    size = flat.shape[0]
    n_chunks = -(-size // (n * chunk))
    padded = n * n_chunks * chunk
    blocks = torch.nn.functional.pad(flat, (0, padded - size)).reshape(n, n_chunks * chunk)
    received = all_to_all_rows(_quantize_chunks(blocks, chunk))
    repacked = _dequantize_chunks(received, chunk, "sum", requantize=True)
    gathered = all_gather_rows(repacked)
    return _dequantize_chunks(gathered, chunk, "concat")[:size].to(orig_dtype)


def compressed_psum(flat: Tensor, spec: CompressionSpec) -> Tensor:
    """A bucket's all-reduce through the spec's compression mode."""
    if spec.mode == "bf16":
        return psum_bf16(flat)
    if spec.mode == "int8":
        return psum_int8(flat, spec.chunk)
    raise ValueError(f"unknown compression mode {spec.mode!r}")


def psum_scatter_bf16(mat: Tensor) -> Tensor:
    """Reduce-scatter ``(n, K) -> (K,)`` with a bfloat16 wire payload."""
    return reduce_scatter_rows(mat.to(torch.bfloat16)).to(mat.dtype)


def psum_scatter_int8(mat: Tensor, chunk: int = DEFAULT_CHUNK) -> Tensor:
    """Reduce-scatter ``(n, K) -> (K,)`` as the int8 exchange's phase 1 and sum: one collective, one
    quantization stage (the senders'); the float32 sum of this rank's block is the result."""
    orig_dtype = mat.dtype
    mat = mat.to(torch.float32)
    k = mat.shape[1]
    n_chunks = -(-k // chunk)
    blocks = torch.nn.functional.pad(mat, (0, n_chunks * chunk - k))
    received = all_to_all_rows(_quantize_chunks(blocks, chunk))
    return _dequantize_chunks(received, chunk, "sum")[:k].to(orig_dtype)


def compressed_psum_scatter(mat: Tensor, spec: CompressionSpec) -> Tensor:
    """A sharded bucket's ``(n, K) -> (K,)`` reduce-scatter through the spec's compression mode."""
    if spec.mode == "bf16":
        return psum_scatter_bf16(mat)
    if spec.mode == "int8":
        return psum_scatter_int8(mat, spec.chunk)
    raise ValueError(f"unknown compression mode {spec.mode!r}")


# --------------------------------------------------------- wire-byte models
def int8_block_bytes(size: int, n_devices: int, chunk: int = DEFAULT_CHUNK) -> int:
    """Packed bytes of one destination block in the int8 two-phase exchange."""
    n_chunks = -(-size // (n_devices * chunk))
    return n_chunks * chunk + SCALE_BYTES * n_chunks


def _granule_ceil(nbytes: int, granule: Optional[int]) -> int:
    if granule is None or granule <= 0:
        return nbytes
    return -(-nbytes // granule) * granule


def bucket_wire_bytes(
    size: int,
    itemsize: int,
    n_devices: int,
    spec: Optional[CompressionSpec],
    granule: Optional[int] = None,
    sharded: bool = False,
) -> int:
    """Modelled wire bytes a rank moves for one bucket: ``2(n-1)`` hops of a ring all-reduce (exact and bf16;
    ``2(n-1)`` packed blocks for int8), ``n-1`` for a sharded bucket's reduce-scatter. ``granule=None`` is
    the granule-free model; an integer rounds each hop up to it."""
    n = int(n_devices)
    if n <= 1:
        return 0
    if spec is None or spec.mode == "none":
        payload = size * itemsize
    elif spec.mode == "bf16":
        payload = size * 2
    elif spec.mode == "int8":
        block = int8_block_bytes(size, n, spec.chunk)
        hops = (n - 1) if sharded else 2 * (n - 1)
        return hops * _granule_ceil(block, granule)
    else:
        raise ValueError(f"unknown compression mode {spec.mode!r}")
    hops = (n - 1) if sharded else 2 * (n - 1)
    if granule is None:
        return int(round(hops / n * payload))
    return hops * _granule_ceil(-(-payload // n), granule)


def host_compressed_payload_bytes(size: int, itemsize: int, spec: Optional[CompressionSpec]) -> int:
    """Bytes a process ships for one bucket in the host gather."""
    if spec is None or spec.mode == "none":
        return size * itemsize
    if spec.mode == "bf16":
        return size * 2
    if spec.mode == "int8":
        n_chunks = -(-size // spec.chunk)
        return size + SCALE_BYTES * n_chunks
    raise ValueError(f"unknown compression mode {spec.mode!r}")


# ------------------------------------------------- host path: one stage
def host_quantize_int8(flat: Tensor, chunk: int = DEFAULT_CHUNK) -> Tensor:
    """Pack a float32 vector into the uint8 ``[int8 payload | float32 scales]`` layout (padded to whole chunks)."""
    flat = torch.as_tensor(flat).to(torch.float32).reshape(-1)
    size = flat.shape[0]
    n_chunks = -(-size // chunk)
    padded = torch.nn.functional.pad(flat, (0, n_chunks * chunk - size))
    return _quantize_chunks(padded.reshape(1, -1), chunk, host_scale=True)[0]


def host_dequantize_int8(packed: Tensor, size: int, chunk: int = DEFAULT_CHUNK) -> Tensor:
    """Inverse of :func:`host_quantize_int8`, trimmed back to ``size`` values."""
    packed = torch.as_tensor(packed).to(torch.uint8).reshape(1, -1)
    return _dequantize_chunks(packed, chunk, "concat")[:size]


def host_dequantize_sum_int8(gathered: Tensor, size: int, chunk: int = DEFAULT_CHUNK) -> Tensor:
    """The float32 sum of every process's packed vector (``(n_proc, packed)``), in process order, trimmed to
    ``size``: one ``int8_dequant_sum`` launch on a CUDA tensor."""
    return _dequantize_chunks(gathered, chunk, "sum", host=True)[:size]


# ------------------------------------------------------ ragged bitpack width
_PACK_CANDIDATES = (torch.uint8, torch.int8, torch.int32)


def packed_int_dtype(dtype: torch.dtype, value_range: Tuple[float, float]) -> torch.dtype:
    """The narrowest integer type that holds a declared ``(lo, hi)``; ``dtype`` itself for float leaves or
    when nothing narrower fits. The candidates are the integer types NCCL and gloo both gather (uint8, int8,
    int32): JAX's uint16/int16 steps are left out, so a range that fits 16 bits travels as int32."""
    if dtype.is_floating_point or dtype == torch.bool:
        return dtype
    lo, hi = value_range
    if lo > hi:
        raise ValueError(f"value_range lo must be <= hi, got {value_range!r}")
    width = torch.iinfo(dtype).bits
    for cand in _PACK_CANDIDATES:
        info = torch.iinfo(cand)
        if info.bits < width and info.min <= lo and hi <= info.max:
            return cand
    return dtype
