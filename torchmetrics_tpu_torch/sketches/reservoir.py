"""Deterministic bottom-k reservoir (counterpart of ``torchmetrics_tpu/sketches/reservoir.py``).

Each record's priority is a seeded hash of its integer key; the reservoir
keeps the ``capacity`` smallest priorities ("bottom-k by hash"), a
fixed-shape sort-and-slice, so insert and merge have static shapes. The merge
of any number of reservoirs sorts the union and keeps k: with distinct keys
it equals the reservoir of the single concatenated stream.

Cross-rank sync is declared by ``reduce_spec`` as a structural
:class:`~torchmetrics_tpu_torch.core.reductions.SketchReduce`: one
fixed-shape ``all_gather`` of ``(capacity, 1 + fields)`` floats and
``combine_stacked``.

The sort is ``torch.sort(stable=True)``, which orders ties as JAX's
``argsort(stable=True)`` does (by position), so the kept rows are JAX's bit
for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.reductions import SketchReduce
from torchmetrics_tpu_torch.sketches.cardinality import mix32

__all__ = ["EMPTY_PRIORITY", "ReservoirSketch"]

#: priority of an unfilled slot: sorts after every real priority in [0, 1]
EMPTY_PRIORITY = 2.0


@dataclass(frozen=True)
class ReservoirSketch:
    """Static config of a bottom-k reservoir of ``(priority, *fields)`` rows.

    State layout: ``(capacity, 1 + fields)`` float32; column 0 is the
    hash-derived priority, columns ``1:`` the payload. Unfilled slots carry
    :data:`EMPTY_PRIORITY` and a zero payload.
    """

    capacity: int
    fields: int
    seed: int = 0x01000193

    def __post_init__(self) -> None:
        if self.capacity < 1:
            raise ValueError(f"ReservoirSketch needs capacity >= 1, got {self.capacity}")
        if self.fields < 1:
            raise ValueError(f"ReservoirSketch needs fields >= 1, got {self.fields}")

    @property
    def row_width(self) -> int:
        return 1 + self.fields

    @property
    def reduce_spec(self) -> SketchReduce:
        return SketchReduce(kind="reservoir", bucket_op=None, combine_stacked=self.combine_stacked)

    def init(self, device: Union[str, torch.device] = "cpu") -> Tensor:
        out = torch.zeros((self.capacity, self.row_width), dtype=torch.float32, device=device)
        out[:, 0] = EMPTY_PRIORITY
        return out

    def priority(self, keys: Tensor) -> Tensor:
        """Deterministic uniform-[0, 1] priority of each integer key: the hash rounded to float32, times 2**-32."""
        return mix32(keys, self.seed).to(torch.float32) * 2.0**-32

    def insert_batch(self, reservoir: Tensor, records: Tensor, keys: Tensor) -> Tensor:
        """Fold ``(n, fields)`` records keyed by ``(n,)`` integer keys in: sort the ``capacity + n`` rows by
        priority (stable), keep the first ``capacity``."""
        pri = self.priority(keys.reshape(-1).to(reservoir.device))
        cand = torch.cat([pri[:, None], records.to(device=reservoir.device, dtype=torch.float32)], dim=1)
        return self.combine_stacked(torch.cat([reservoir, cand], dim=0))

    def combine_stacked(self, stacked: Tensor) -> Tensor:
        """Merge ``(m, capacity, 1 + fields)`` stacked reservoirs (or any ``(..., 1 + fields)`` rows) into one:
        the ``SketchReduce.combine_stacked`` hook."""
        merged = stacked.reshape(-1, self.row_width)
        order = torch.sort(merged[:, 0], stable=True).indices[: self.capacity]
        return merged[order]

    def merge(self, a: Tensor, b: Tensor) -> Tensor:
        return self.combine_stacked(torch.stack([a, b]))

    # ------------------------------------------------------------- inspection
    def count(self, reservoir: Tensor) -> Tensor:
        """Number of real (non-empty) rows held."""
        return (reservoir[:, 0] < 1.5).sum().to(torch.int32)

    def payload(self, reservoir: Tensor) -> Tensor:
        """``(capacity, fields)`` payload columns (empty rows are zero)."""
        return reservoir[:, 1:]

    def valid_mask(self, reservoir: Tensor) -> Tensor:
        """``(capacity,)`` bool, True where the row holds a real record."""
        return reservoir[:, 0] < 1.5

    def scale_factor(self, reservoir: Tensor, total_seen: Tensor) -> Tensor:
        """Per-record estimator weight ``total_seen / kept``."""
        kept = torch.clamp_min(self.count(reservoir).to(torch.float32), 1.0)
        return torch.as_tensor(total_seen).to(torch.float32) / kept
