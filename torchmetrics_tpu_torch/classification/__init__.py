"""Classification metrics of the port: the multiclass family."""

from torchmetrics_tpu_torch.classification.accuracy import Accuracy, MulticlassAccuracy
from torchmetrics_tpu_torch.classification.auroc import AUROC, MulticlassAUROC
from torchmetrics_tpu_torch.classification.average_precision import AveragePrecision, MulticlassAveragePrecision
from torchmetrics_tpu_torch.classification.f_beta import F1Score, FBetaScore, MulticlassF1Score, MulticlassFBetaScore
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    MulticlassPrecisionRecallCurve,
    PrecisionRecallCurve,
)
from torchmetrics_tpu_torch.classification.stat_scores import MulticlassStatScores, StatScores

__all__ = [
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "F1Score",
    "FBetaScore",
    "MulticlassAUROC",
    "MulticlassAccuracy",
    "MulticlassAveragePrecision",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassPrecisionRecallCurve",
    "MulticlassStatScores",
    "PrecisionRecallCurve",
    "StatScores",
]
