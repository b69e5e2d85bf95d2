"""Utilities of the port (counterpart of ``torchmetrics_tpu/utilities/__init__.py``), for the names ported so far."""

from torchmetrics_tpu_torch.utilities.data import dim_zero_cat
from torchmetrics_tpu_torch.utilities.exceptions import TorchMetricsUserError
from torchmetrics_tpu_torch.utilities.formatting import classify_inputs
from torchmetrics_tpu_torch.utilities.prints import rank_zero_info, rank_zero_warn

__all__ = ["classify_inputs", "dim_zero_cat", "rank_zero_info", "rank_zero_warn", "TorchMetricsUserError"]
