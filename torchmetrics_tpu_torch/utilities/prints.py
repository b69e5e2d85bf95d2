"""Rank-zero warning helper (counterpart of ``torchmetrics_tpu/utilities/prints.py``).

The rank is ``torch.distributed``'s when a process group is up, else 0.
"""

from __future__ import annotations

import warnings
from typing import Any

import torch.distributed as dist


def _rank() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def rank_zero_warn(message: str, *args: Any, **kwargs: Any) -> None:
    """``warnings.warn`` on rank 0 only."""
    if _rank() != 0:
        return
    kwargs.setdefault("stacklevel", 4)
    warnings.warn(message, *args, **kwargs)
