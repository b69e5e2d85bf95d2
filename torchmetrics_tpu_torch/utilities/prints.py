"""Rank-zero warning and logging helpers (counterpart of ``torchmetrics_tpu/utilities/prints.py``).

The rank is ``torch.distributed``'s when a process group is up, else 0.
"""

from __future__ import annotations

import logging
import warnings
from typing import Any

import torch.distributed as dist

log = logging.getLogger("torchmetrics_tpu_torch")
if not any(isinstance(h, logging.NullHandler) for h in log.handlers):
    log.addHandler(logging.NullHandler())


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


def rank_zero_info(message: str, *args: Any, **kwargs: Any) -> None:
    """``logging.info`` on the package's logger, on rank 0 only."""
    if _rank() == 0:
        log.info(message, *args, **kwargs)
