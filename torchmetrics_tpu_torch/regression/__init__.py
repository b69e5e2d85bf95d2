"""Regression metrics of the port."""

from torchmetrics_tpu_torch.regression.errors import MeanSquaredError

__all__ = ["MeanSquaredError"]
