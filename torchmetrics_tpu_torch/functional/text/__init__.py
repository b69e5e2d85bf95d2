"""Functional text metrics of the port (counterpart of ``torchmetrics_tpu/functional/text/``).

The other text metrics of the JAX package wait for their slice.
"""

from torchmetrics_tpu_torch.functional.text.rouge import rouge_score

__all__ = ["rouge_score"]
