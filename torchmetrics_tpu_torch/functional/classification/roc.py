"""Binned ROC pieces (counterpart of ``torchmetrics_tpu/functional/classification/roc.py``)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.compute import _safe_divide


def _binary_roc_compute_binned(confmat: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """``(fpr, tpr, thresholds)`` from a ``(T, ..., 2, 2)`` binned confusion state.

    Flipped along T so that fpr rises (thresholds descending). The JAX
    version takes one ``(T, 2, 2)`` curve; any batch dims between T and the
    2x2 cell (the classes) are kept, so all curves come out in one pass.
    """
    tp = confmat[..., 1, 1]
    fp = confmat[..., 0, 1]
    fn = confmat[..., 1, 0]
    tn = confmat[..., 0, 0]
    tpr = torch.flip(_safe_divide(tp, tp + fn), (0,))
    fpr = torch.flip(_safe_divide(fp, fp + tn), (0,))
    return fpr, tpr, torch.flip(thresholds, (0,))
