"""Clustering metrics (counterpart of ``torchmetrics_tpu/clustering/``)."""

from torchmetrics_tpu_torch.clustering.extrinsic import (
    AdjustedMutualInfoScore,
    AdjustedRandScore,
    CompletenessScore,
    FowlkesMallowsIndex,
    HomogeneityScore,
    MutualInfoScore,
    NormalizedMutualInfoScore,
    RandScore,
    VMeasureScore,
)
from torchmetrics_tpu_torch.clustering.intrinsic import (
    CalinskiHarabaszScore,
    DaviesBouldinScore,
    DunnIndex,
)

__all__ = [
    "AdjustedMutualInfoScore",
    "AdjustedRandScore",
    "CalinskiHarabaszScore",
    "CompletenessScore",
    "DaviesBouldinScore",
    "DunnIndex",
    "FowlkesMallowsIndex",
    "HomogeneityScore",
    "MutualInfoScore",
    "NormalizedMutualInfoScore",
    "RandScore",
    "VMeasureScore",
]
