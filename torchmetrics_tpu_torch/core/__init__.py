"""The port's metric base, composition and reductions (counterpart of ``torchmetrics_tpu/core``).

The warm-start exports of the JAX package wait for ``core/warmstart.py``.
"""

from torchmetrics_tpu_torch.core.composition import CompositionalMetric
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.core.reductions import Reduce

__all__ = ["CompositionalMetric", "Metric", "Reduce"]
