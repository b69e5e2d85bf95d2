"""PyTorch/CUDA port of ``torchmetrics_tpu``.

A second package beside the JAX one, with the same module paths and names.
It imports ``torch`` and ``numpy`` only: never ``jax``, and nothing from
``torchmetrics_tpu``. Metrics run on the current CUDA device unless given
``device=...``; without CUDA and without a device they raise.
"""

from torchmetrics_tpu_torch.classification import (
    AUROC,
    Accuracy,
    AveragePrecision,
    CohenKappa,
    ConfusionMatrix,
    F1Score,
    FBetaScore,
    HammingDistance,
    JaccardIndex,
    MatthewsCorrCoef,
    MulticlassAccuracy,
    MulticlassAUROC,
    MulticlassAveragePrecision,
    MulticlassF1Score,
    MulticlassFBetaScore,
    MulticlassPrecisionRecallCurve,
    MulticlassStatScores,
    NegativePredictiveValue,
    Precision,
    PrecisionRecallCurve,
    Recall,
    Specificity,
    StatScores,
)
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.core.composition import CompositionalMetric
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.regression import MeanSquaredError

__all__ = [
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "CohenKappa",
    "CompositionalMetric",
    "ConfusionMatrix",
    "F1Score",
    "FBetaScore",
    "HammingDistance",
    "JaccardIndex",
    "MatthewsCorrCoef",
    "MeanSquaredError",
    "Metric",
    "MetricCollection",
    "MulticlassAUROC",
    "MulticlassAccuracy",
    "MulticlassAveragePrecision",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassPrecisionRecallCurve",
    "MulticlassStatScores",
    "NegativePredictiveValue",
    "Precision",
    "PrecisionRecallCurve",
    "Recall",
    "Specificity",
    "StatScores",
]
