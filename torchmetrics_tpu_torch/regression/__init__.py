"""Regression metrics of the port."""

from torchmetrics_tpu_torch.regression.correlation import (
    ConcordanceCorrCoef,
    KendallRankCorrCoef,
    PearsonCorrCoef,
    SpearmanCorrCoef,
)
from torchmetrics_tpu_torch.regression.distribution import CosineSimilarity, KLDivergence
from torchmetrics_tpu_torch.regression.errors import (
    CriticalSuccessIndex,
    LogCoshError,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    MinkowskiDistance,
    SymmetricMeanAbsolutePercentageError,
    TweedieDevianceScore,
    WeightedMeanAbsolutePercentageError,
)
from torchmetrics_tpu_torch.regression.variance import ExplainedVariance, R2Score, RelativeSquaredError

__all__ = [
    "ConcordanceCorrCoef",
    "CosineSimilarity",
    "CriticalSuccessIndex",
    "ExplainedVariance",
    "KendallRankCorrCoef",
    "KLDivergence",
    "LogCoshError",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "MinkowskiDistance",
    "PearsonCorrCoef",
    "R2Score",
    "RelativeSquaredError",
    "SpearmanCorrCoef",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
]
