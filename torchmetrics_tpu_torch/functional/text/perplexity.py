"""Perplexity (counterpart of ``torchmetrics_tpu/functional/text/perplexity.py``).

The one text metric whose inputs are tensors, ``(B, T, V)`` logits: its
update is one launch of the ``perplexity_nll`` CUDA kernel on the card
(``kernels/perplexity.py``: the log-softmax, the gather and the masked sums in
one pass over the logits); the CPU takes its plain version, JAX's float32
``log_softmax`` form. Both are differentiable.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.text.perplexity import perplexity
    >>> logits = torch.log(torch.tensor([[[0.7, 0.2, 0.1], [0.1, 0.8, 0.1]]]))
    >>> target = torch.tensor([[0, 1]])
    >>> round(float(perplexity(logits, target)), 4)
    1.3363
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels.perplexity import KINDS, _perplexity_nll_plain, perplexity_nll


def _perplexity_update(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Returns (total negative log-probability, token count), float32: one ``perplexity_nll`` launch on the card,
    its plain version elsewhere."""
    if preds.ndim != 3:
        raise ValueError(
            "Input tensor `preds` is expected to have 3 dimensions, [batch_size, seq_len, vocab_size],"
            f" but got {preds.ndim}."
        )
    if target.ndim != 2:
        raise ValueError(
            f"Input tensor `target` is expected to have 2 dimensions, [batch_size, seq_len], but got {target.ndim}."
        )
    if preds.shape[:2] != target.shape:
        raise ValueError(
            "Input tensors `preds` and `target` are expected to have equaling first two dimensions,"
            f" [batch_size, seq_len], but got {tuple(preds.shape[:2])} and {tuple(target.shape)}."
        )
    logits = preds.reshape(-1, preds.shape[-1])
    target = target.reshape(-1)
    if preds.device.type == "cuda":
        if logits.dtype not in KINDS:
            logits = logits.to(torch.float32)
        if target.dtype not in (torch.int32, torch.int64):
            target = target.to(torch.int64)
        return perplexity_nll(logits.contiguous(), target.contiguous(), ignore_index)
    return _perplexity_nll_plain(logits, target, ignore_index)


def _perplexity_compute(total: Tensor, count: Tensor) -> Tensor:
    return torch.exp(total / count)


def perplexity(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tensor:
    """exp of the mean negative log-likelihood of the target tokens."""
    total, count = _perplexity_update(preds, target, ignore_index)
    return _perplexity_compute(total, count)
