"""Multimodal metrics (counterpart of ``torchmetrics_tpu/multimodal/``)."""

from torchmetrics_tpu_torch.multimodal.clip_iqa import CLIPImageQualityAssessment
from torchmetrics_tpu_torch.multimodal.clip_score import CLIPScore

__all__ = ["CLIPImageQualityAssessment", "CLIPScore"]
