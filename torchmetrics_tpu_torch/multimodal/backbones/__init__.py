"""The CLIP encoders of the multimodal metrics (counterpart of ``torchmetrics_tpu/multimodal/backbones/``)."""

from torchmetrics_tpu_torch.multimodal.backbones.clip import (
    CLIPImageEncoder,
    CLIPTextEncoder,
    load_clip_encoders,
)

__all__ = ["CLIPImageEncoder", "CLIPTextEncoder", "load_clip_encoders"]
