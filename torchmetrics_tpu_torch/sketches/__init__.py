"""Fixed-size, mergeable sketch states (counterpart of ``torchmetrics_tpu/sketches``).

Unbounded ``cat`` states make a metric's sync grow with the sample count and
the world size (ragged gathers). The sketches here are the bounded
replacements: each is a fixed-shape tensor with ``init / insert_batch /
merge / query`` operations whose merge is elementwise (or a fixed top-k), so
a cross-rank sync is an ordinary ``all_reduce`` that the coalescing planner
buckets, or one fixed-shape gather.

Metrics opt in by ``Metric(approx="sketch", approx_error=...)`` (or
``approx="reservoir"`` for the text metrics); the default ``approx=None``
path stays exact. Each sketch exposes a ``reduce_spec``
(:class:`~torchmetrics_tpu_torch.core.reductions.SketchReduce`) to pass as
``add_state(..., dist_reduce_fx=...)``.

================  =====================================  ====================
sketch            state / merge                          documented error
================  =====================================  ====================
QuantileSketch    ``(…, bins+1)`` histogram, ``+``       value/threshold
                                                         resolution ``eps``
HyperLogLog       ``(2^p,)`` registers, ``max``          ``1.04/sqrt(2^p)``
                                                         RSE on distinct count
CountMinSketch    ``(d, w)`` counters, ``+``             over ``<= e/w`` of
                                                         total weight
ReservoirSketch   ``(k, 1+F)`` bottom-k rows, sort+k     uniform k-sample
                                                         (reweight by N/k)
================  =====================================  ====================

Two inserts have hand CUDA kernels on the card: the curve family's histogram
pair (``kernels.quantile_hist``) and DistinctNGrams' windows into
HyperLogLog registers (``kernels.hll``). The count-min insert and the
reservoir's sort are plain PyTorch.
"""

from torchmetrics_tpu_torch.core.reductions import SketchReduce, is_sketch_reduce
from torchmetrics_tpu_torch.sketches.cardinality import CountMinSketch, HyperLogLog, mix32
from torchmetrics_tpu_torch.sketches.quantile import DEFAULT_APPROX_ERROR, QuantileSketch, bins_for_error
from torchmetrics_tpu_torch.sketches.reservoir import EMPTY_PRIORITY, ReservoirSketch

__all__ = [
    "CountMinSketch",
    "DEFAULT_APPROX_ERROR",
    "EMPTY_PRIORITY",
    "HyperLogLog",
    "QuantileSketch",
    "ReservoirSketch",
    "SketchReduce",
    "bins_for_error",
    "is_sketch_reduce",
    "mix32",
]
