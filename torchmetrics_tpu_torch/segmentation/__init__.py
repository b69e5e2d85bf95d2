"""Segmentation metrics (counterpart of ``torchmetrics_tpu/segmentation/``)."""

from torchmetrics_tpu_torch.segmentation.generalized_dice import GeneralizedDiceScore
from torchmetrics_tpu_torch.segmentation.mean_iou import MeanIoU

__all__ = ["GeneralizedDiceScore", "MeanIoU"]
