"""Fixed-grid quantile sketch (counterpart of ``torchmetrics_tpu/sketches/quantile.py``).

A weighted histogram over ``bins + 1`` cells of a known value range, held
as one fixed-shape float32 tensor, whose merge is elementwise ``+``. It
replaces the unbounded ``cat`` states of the curve family's exact path.

Guarantees (``eps = (hi - lo) / bins``, the grid spacing):

* every cell boundary count is exact: ``tail_counts(hist)[i]`` is the total
  weight of inserted values ``>= edges[i]``;
* ``query(hist, q)`` returns a value within ``eps`` of some true
  ``q'``-quantile with ``|q' - q| <=`` (mass of one cell);
* for ROC/PR curves built from a ``(neg, pos)`` histogram pair, every
  reported point lies exactly on the exact curve;
* trapezoidal AUROC deviates from exact by at most ``auc_error_bound(hist)``
  = ``0.5 * sum_b pos_frac_b * neg_frac_b``.

State layout: ``(*prefix, bins + 1)``; cell ``i < bins`` covers
``[edges[i], edges[i+1])`` and the last cell holds ``value == hi`` (and
everything above it). A NaN lands in cell 0, as JAX's cast of a NaN does on
the CPU and the TPU; torch's cast of a NaN to an integer is undefined, so
:meth:`QuantileSketch.cell_index` replaces it before the cast.

A float32 cell of 0/1 weights counts exactly up to ``2**24`` entries, as
JAX's does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.reductions import SketchReduce

__all__ = ["DEFAULT_APPROX_ERROR", "QuantileSketch", "bins_for_error"]

#: default grid resolution for ``Metric(approx="sketch")`` when no ``approx_error`` is given:
#: 1/200, 201 curve thresholds
DEFAULT_APPROX_ERROR = 1.0 / 200.0


def bins_for_error(eps: float, lo: float = 0.0, hi: float = 1.0) -> int:
    """Cell count whose grid spacing over ``[lo, hi]`` is at most ``eps``."""
    if not (0.0 < eps <= (hi - lo)):
        raise ValueError(f"approx_error must be in (0, {hi - lo}], got {eps}")
    return max(2, int(math.ceil((hi - lo) / eps)))


def _linspace32(lo: float, hi: float, num: int) -> np.ndarray:
    """``jnp.linspace(lo, hi, num, dtype=float32)``: ``lo * (1 - s) + hi * s`` in float32 with
    ``s = i * (1 / (num - 1))``, the last point ``hi``.

    On ``[0, 1]``, every metric's grid, that is JAX's grid bit for bit (XLA
    compiles the division to that product). On other ranges XLA's CPU compiler
    rearranges the float32 arithmetic, and points differ from JAX's by at most
    ``2**-23 * (hi - lo)``.
    """
    div = num - 1
    step = np.arange(div, dtype=np.float32) * (np.float32(1.0) / np.float32(div))
    lo32, hi32 = np.float32(lo), np.float32(hi)
    out = lo32 * (np.float32(1.0) - step) + hi32 * step
    return np.concatenate([out, [hi32]]).astype(np.float32)


@dataclass(frozen=True)
class QuantileSketch:
    """Static config of a fixed-grid quantile sketch (the state is a plain tensor; this object holds no data)."""

    bins: int
    lo: float = 0.0
    hi: float = 1.0

    def __post_init__(self) -> None:
        if self.bins < 2:
            raise ValueError(f"QuantileSketch needs bins >= 2, got {self.bins}")
        if not self.hi > self.lo:
            raise ValueError(f"QuantileSketch needs hi > lo, got [{self.lo}, {self.hi}]")

    @classmethod
    def for_error(cls, eps: Optional[float], lo: float = 0.0, hi: float = 1.0) -> "QuantileSketch":
        """Sketch whose documented value/threshold resolution is ``<= eps``."""
        return cls(bins=bins_for_error(DEFAULT_APPROX_ERROR if eps is None else eps, lo, hi), lo=lo, hi=hi)

    # ------------------------------------------------------------- properties
    @property
    def n_cells(self) -> int:
        return self.bins + 1

    @property
    def eps(self) -> float:
        """Grid spacing, the documented value resolution."""
        return (self.hi - self.lo) / self.bins

    @property
    def scale(self) -> float:
        """``bins / (hi - lo)``, the factor of :meth:`cell_index` (rounded to float32 where it is applied)."""
        return self.bins / (self.hi - self.lo)

    def edges_on(self, device: Union[str, torch.device] = "cpu") -> Tensor:
        """``(bins + 1,)`` float32 cell lower edges, the curve thresholds, on ``device``."""
        return torch.from_numpy(_linspace32(self.lo, self.hi, self.bins + 1)).to(device)

    @property
    def edges(self) -> Tensor:
        return self.edges_on("cpu")

    @property
    def reduce_spec(self) -> SketchReduce:
        """The ``dist_reduce_fx`` of a histogram leaf: merge is elementwise sum (the planner's sum bucket)."""
        return SketchReduce(kind="quantile", bucket_op="sum")

    # -------------------------------------------------------------------- ops
    def init(self, prefix: Tuple[int, ...] = (), dtype: torch.dtype = torch.float32,
             device: Union[str, torch.device] = "cpu") -> Tensor:
        """Fresh empty histogram of shape ``(*prefix, bins + 1)``."""
        return torch.zeros((*prefix, self.n_cells), dtype=dtype, device=device)

    def cell_index(self, values: Tensor) -> Tensor:
        """int64 cell of each value: ``clip(floor((v - lo) * scale), 0, bins)`` in float32, NaN in cell 0."""
        scaled = (values.to(torch.float32) - self.lo) * self.scale
        cell = torch.clamp(torch.floor(scaled), 0, self.bins)
        return torch.nan_to_num(cell, nan=0.0).to(torch.int64)

    def insert_batch(self, hist: Tensor, values: Tensor, weights: Optional[Tensor] = None) -> Tensor:
        """New histogram: a batch folded in by one ``index_add``.

        ``hist`` is ``(*prefix, bins + 1)``; ``values`` (and ``weights``)
        ``(batch, *prefix)``.
        """
        if weights is None:
            weights = torch.ones(values.shape, dtype=hist.dtype, device=hist.device)
        prefix = hist.shape[:-1]
        idx = self.cell_index(values)  # (batch, *prefix)
        n_rows = int(np.prod(prefix, dtype=np.int64)) if prefix else 1
        offsets = (torch.arange(n_rows, dtype=torch.int64, device=hist.device) * self.n_cells).reshape(prefix)
        flat_idx = (idx + offsets).reshape(-1)
        flat = hist.reshape(-1).index_add(0, flat_idx, weights.to(hist.dtype).reshape(-1))
        return flat.reshape(hist.shape)

    def merge(self, a: Tensor, b: Tensor) -> Tensor:
        """Pairwise merge, what ``SketchReduce(bucket_op='sum')`` lowers to across ranks."""
        return a + b

    def total(self, hist: Tensor) -> Tensor:
        """Total inserted weight per prefix row: ``(*prefix,)``."""
        return hist.sum(-1)

    def cdf(self, hist: Tensor, x: Tensor) -> Tensor:
        """Fraction of inserted weight with value ``< edges[cell(x) + 1]``."""
        cum = torch.cumsum(hist, -1)
        i = self.cell_index(x)
        return torch.gather(cum, -1, i[..., None])[..., 0] / torch.clamp_min(cum[..., -1], 1e-12)

    def query(self, hist: Tensor, q) -> Tensor:
        """Approximate ``q``-quantile value(s) per prefix row: the smallest grid edge whose cumulative mass
        reaches ``q * total``."""
        q = torch.as_tensor(q, dtype=hist.dtype, device=hist.device)
        cum = torch.cumsum(hist, -1)  # (*prefix, C)
        target = q[..., None] * cum[..., -1:] if q.ndim else q * cum[..., -1:]
        i = (cum < target).sum(-1)  # first cell where cum >= target
        return self.edges_on(hist.device)[torch.clamp(i, 0, self.bins)]

    # ----------------------------------------------------- curve-metric hooks
    def tail_counts(self, hist: Tensor) -> Tensor:
        """``out[..., i]`` = exact total weight of values ``>= edges[i]``."""
        return torch.flip(torch.cumsum(torch.flip(hist, (-1,)), -1), (-1,))

    def curve_confmat(self, hist: Tensor) -> Tensor:
        """Per-threshold confusion counts ``(bins + 1, *prefix, 2, 2)`` ``[threshold, ..., target, pred]``
        (``pred = score >= edge``) of a ``(*prefix, 2, bins + 1)`` (neg, pos) histogram pair: the binned
        path's state at ``thresholds=edges``."""
        tail = self.tail_counts(hist)  # (*prefix, 2, C)
        total = hist.sum(-1, keepdim=True)  # (*prefix, 2, 1)
        pred1 = torch.movedim(tail, -1, 0)  # (C, *prefix, 2)
        pred0 = torch.movedim(total - tail, -1, 0)
        return torch.stack([pred0, pred1], dim=-1)

    def provenance(self, hist: Optional[Tensor] = None) -> dict:
        """One provenance row for this sketch config: the grid and its ``eps``, and given a
        ``(*prefix, 2, bins + 1)`` curve histogram, the worst row's :meth:`auc_error_bound` as ``bound``.
        Never raises: a histogram of the wrong shape falls back to ``eps``."""
        out = {"source": "sketch", "kind": "quantile", "bins": self.bins, "lo": self.lo, "hi": self.hi,
               "eps": float(self.eps), "bound": float(self.eps)}
        if hist is not None:
            try:
                data_bound = float(self.auc_error_bound(torch.as_tensor(hist)).max())
            except Exception:
                return out
            out["auc_bound"] = data_bound
            out["bound"] = data_bound
        return out

    def auc_error_bound(self, hist: Tensor) -> Tensor:
        """Data-dependent bound on ``|AUROC_sketch - AUROC_exact|`` per prefix row: ``0.5 * sum_b p_b * n_b``
        of a ``(*prefix, 2, bins + 1)`` histogram pair (pairs in one cell score as ties)."""
        neg, pos = hist[..., 0, :], hist[..., 1, :]
        p = pos / torch.clamp_min(pos.sum(-1, keepdim=True), 1e-12)
        n = neg / torch.clamp_min(neg.sum(-1, keepdim=True), 1e-12)
        return 0.5 * (p * n).sum(-1)
