"""Cardinality sketches: HyperLogLog and count-min (counterpart of ``torchmetrics_tpu/sketches/cardinality.py``).

Both are fixed integer or float register arrays whose merge is elementwise
(``max`` for HyperLogLog, ``+`` for count-min), so their cross-rank sync is
one ``all_reduce`` riding the coalescing planner's fused buckets.

Hashing is the murmur3 finalizer with fixed, seeded constants, the JAX
package's bit for bit. Torch's ``uint32`` supports few operations, so a hash
is held in an ``int64`` tensor whose values lie in ``[0, 2**32)``; each
32-bit product is taken as two products of 16-bit halves of the constant,
which stay below ``2**49``, and masked. The leading-zero count that
HyperLogLog's rank needs comes from ``torch.frexp`` of the value as float64,
which holds every uint32 exactly.

Error bounds (documented, standard):

* HyperLogLog with ``m = 2**precision`` registers estimates distinct counts
  with relative standard error ``~1.04 / sqrt(m)``;
* count-min with width ``w`` and depth ``d`` never undercounts and
  overcounts by at most ``(e / w) * total_weight`` with probability
  ``1 - exp(-d)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.reductions import SketchReduce

__all__ = ["CountMinSketch", "HyperLogLog", "mix32"]

_M32 = 0xFFFFFFFF
#: golden-ratio increment, the classic multiplicative-hash salt
_GOLDEN = 0x9E3779B9


def _u32(x: Union[Tensor, int]) -> Union[Tensor, int]:
    """``x`` wrapped to 32 bits (an int32 -1 is 0xFFFFFFFF), as an int64 tensor or a Python int."""
    if isinstance(x, Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _mul32(x: Tensor, c: int) -> Tensor:
    """``x * c mod 2**32`` of int64 values in ``[0, 2**32)``, without an int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def mix32(x: Tensor, salt: Union[Tensor, int]) -> Tensor:
    """32-bit avalanche mix (murmur3 finalizer) of integer keys, as JAX's ``uint32`` arithmetic gives it.

    ``x`` is any integer tensor (wrapped to 32 bits first); ``salt`` a Python
    int or an integer tensor that broadcasts against ``x``. Returns int64
    values in ``[0, 2**32)``.
    """
    x = _u32(x) ^ _u32(salt)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _leading_zeros32(x: Tensor) -> Tensor:
    """``clz`` of int64 values in ``(0, 2**32)``: ``32 - e`` where ``x = m * 2**e``, ``m`` in [0.5, 1)."""
    return 32 - torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)


def hll_index_rank(h: Tensor, precision: int) -> tuple:
    """HyperLogLog's register index (the top ``precision`` bits) and rank (leading zeros of the rest, plus one;
    ``32 - precision + 1`` where the rest is 0) of int64 hashes in ``[0, 2**32)``, both int64."""
    idx = h >> (32 - precision)
    rest = (h << precision) & _M32
    max_rank = 32 - precision + 1
    rank = torch.where(rest == 0, max_rank, _leading_zeros32(torch.clamp_min(rest, 1)) + 1)
    return idx, rank


@dataclass(frozen=True)
class HyperLogLog:
    """HLL distinct-count registers: ``(2**precision,)`` int32, merge = max."""

    precision: int = 11
    seed: int = 0x1B873593

    def __post_init__(self) -> None:
        if not (4 <= self.precision <= 18):
            raise ValueError(f"HyperLogLog precision must be in [4, 18], got {self.precision}")

    @classmethod
    def for_error(cls, eps: Optional[float], seed: int = 0x1B873593) -> "HyperLogLog":
        """Registers sized so the relative standard error is ``<= eps``."""
        if eps is None:
            return cls(seed=seed)
        p = int(math.ceil(math.log2((1.04 / eps) ** 2)))
        return cls(precision=min(max(p, 4), 18), seed=seed)

    @property
    def m(self) -> int:
        return 1 << self.precision

    @property
    def relative_error(self) -> float:
        """Documented RSE of :meth:`estimate`: ``1.04 / sqrt(m)``."""
        return 1.04 / math.sqrt(self.m)

    @property
    def reduce_spec(self) -> SketchReduce:
        return SketchReduce(kind="hll", bucket_op="max")

    def init(self, device: Union[str, torch.device] = "cpu") -> Tensor:
        return torch.zeros((self.m,), dtype=torch.int32, device=device)

    def insert_batch(self, registers: Tensor, keys: Tensor, mask: Optional[Tensor] = None) -> Tensor:
        """New registers: ``max(register, rank of the hashed key)``, one ``scatter_reduce`` (amax).

        ``mask`` (the shape of ``keys``) drops entries: a masked key's rank is
        0, which no register is below.
        """
        idx, rank = hll_index_rank(mix32(keys.reshape(-1), self.seed), self.precision)
        if mask is not None:
            rank = torch.where(mask.reshape(-1), rank, 0)
        return registers.scatter_reduce(0, idx, rank.to(registers.dtype), reduce="amax", include_self=True)

    def merge(self, a: Tensor, b: Tensor) -> Tensor:
        return torch.maximum(a, b)

    def estimate(self, registers: Tensor) -> Tensor:
        """Distinct-count estimate: the harmonic mean, with linear counting in the small range (float32)."""
        m = float(self.m)
        if self.m >= 128:
            alpha = 0.7213 / (1.0 + 1.079 / m)
        elif self.m >= 64:
            alpha = 0.709
        elif self.m >= 32:
            alpha = 0.697
        else:
            alpha = 0.673
        regs = registers.to(torch.float32)
        raw = alpha * m * m / torch.exp2(-regs).sum()
        zeros = (registers == 0).sum().to(torch.float32)
        linear = m * torch.log(m / torch.clamp_min(zeros, 1.0))
        return torch.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)


@dataclass(frozen=True)
class CountMinSketch:
    """Count-min frequency table: ``(depth, width)`` counters, merge = sum."""

    width: int
    depth: int = 4
    seed: int = 0x7FEB352D

    def __post_init__(self) -> None:
        if self.width < 1 or self.depth < 1:
            raise ValueError(f"CountMinSketch needs width/depth >= 1, got {self.width}x{self.depth}")

    @classmethod
    def for_error(cls, eps: float, delta: float = 0.01, seed: int = 0x7FEB352D) -> "CountMinSketch":
        """Table sized so queries overcount by ``<= eps * total_weight`` with probability ``>= 1 - delta``."""
        width = max(1, int(math.ceil(math.e / eps)))
        depth = max(1, int(math.ceil(math.log(1.0 / delta))))
        return cls(width=width, depth=depth, seed=seed)

    @property
    def overcount_fraction(self) -> float:
        """Documented per-query overcount bound as a fraction of the total inserted weight: ``e / width``."""
        return math.e / self.width

    @property
    def reduce_spec(self) -> SketchReduce:
        return SketchReduce(kind="countmin", bucket_op="sum")

    def init(self, dtype: torch.dtype = torch.float32, device: Union[str, torch.device] = "cpu") -> Tensor:
        return torch.zeros((self.depth, self.width), dtype=dtype, device=device)

    def _row_cols(self, keys: Tensor) -> Tensor:
        """``(depth, n)`` int64 column of each key in each row (a salt a row)."""
        salts = (self.seed + _GOLDEN * torch.arange(self.depth, dtype=torch.int64, device=keys.device)) & _M32
        return mix32(keys.reshape(-1)[None, :], salts[:, None]) % self.width

    def insert_batch(self, table: Tensor, keys: Tensor, weights: Optional[Tensor] = None) -> Tensor:
        """New table: each key's weight added into one cell a row (one ``index_add``)."""
        flat_keys = keys.reshape(-1)
        if weights is None:
            w = torch.ones((flat_keys.shape[0],), dtype=table.dtype, device=table.device)
        else:
            w = weights.reshape(-1).to(table.dtype)
        cols = self._row_cols(flat_keys)  # (depth, n)
        rows = torch.arange(self.depth, dtype=torch.int64, device=table.device)[:, None] * self.width
        flat_w = w[None, :].expand(cols.shape).reshape(-1)
        return table.reshape(-1).index_add(0, (cols + rows).reshape(-1), flat_w).reshape(table.shape)

    def merge(self, a: Tensor, b: Tensor) -> Tensor:
        return a + b

    def query(self, table: Tensor, keys: Tensor) -> Tensor:
        """Estimated weight of each key: the minimum over rows, which never undercounts."""
        cols = self._row_cols(keys)  # (depth, n)
        return torch.gather(table, 1, cols).amin(0).reshape(keys.shape)
