"""Detection metrics of the port."""

from torchmetrics_tpu_torch.detection.mean_ap import MeanAveragePrecision

__all__ = ["MeanAveragePrecision"]
