"""Text metrics of the port."""

from torchmetrics_tpu_torch.text.rouge import ROUGEScore

__all__ = ["ROUGEScore"]
