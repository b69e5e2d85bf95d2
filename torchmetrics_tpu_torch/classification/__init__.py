"""Classification metrics of the port: the stat-scores and confusion-matrix families and
the curve family (precision-recall curve, ROC, AUROC, average precision) for the three tasks, calibration
error, hinge loss, exact match, multilabel ranking, group fairness, Dice and the fixed operating points."""

from torchmetrics_tpu_torch.classification.accuracy import (
    Accuracy,
    BinaryAccuracy,
    MulticlassAccuracy,
    MultilabelAccuracy,
)
from torchmetrics_tpu_torch.classification.auroc import AUROC, BinaryAUROC, MulticlassAUROC, MultilabelAUROC
from torchmetrics_tpu_torch.classification.average_precision import (
    AveragePrecision,
    BinaryAveragePrecision,
    MulticlassAveragePrecision,
    MultilabelAveragePrecision,
)
from torchmetrics_tpu_torch.classification.calibration_error import (
    BinaryCalibrationError,
    CalibrationError,
    MulticlassCalibrationError,
)
from torchmetrics_tpu_torch.classification.cohen_kappa import BinaryCohenKappa, CohenKappa, MulticlassCohenKappa
from torchmetrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    ConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from torchmetrics_tpu_torch.classification.dice import Dice
from torchmetrics_tpu_torch.classification.exact_match import ExactMatch, MulticlassExactMatch, MultilabelExactMatch
from torchmetrics_tpu_torch.classification.f_beta import (
    BinaryF1Score,
    BinaryFBetaScore,
    F1Score,
    FBetaScore,
    MulticlassF1Score,
    MulticlassFBetaScore,
    MultilabelF1Score,
    MultilabelFBetaScore,
)
from torchmetrics_tpu_torch.classification.fixed_operating_point import (
    BinaryPrecisionAtFixedRecall,
    BinaryRecallAtFixedPrecision,
    BinarySensitivityAtSpecificity,
    BinarySpecificityAtSensitivity,
    MulticlassPrecisionAtFixedRecall,
    MulticlassRecallAtFixedPrecision,
    MulticlassSensitivityAtSpecificity,
    MulticlassSpecificityAtSensitivity,
    MultilabelPrecisionAtFixedRecall,
    MultilabelRecallAtFixedPrecision,
    MultilabelSensitivityAtSpecificity,
    MultilabelSpecificityAtSensitivity,
    PrecisionAtFixedRecall,
    RecallAtFixedPrecision,
    SensitivityAtSpecificity,
    SpecificityAtSensitivity,
)
from torchmetrics_tpu_torch.classification.group_fairness import BinaryFairness, BinaryGroupStatRates
from torchmetrics_tpu_torch.classification.hamming import (
    BinaryHammingDistance,
    HammingDistance,
    MulticlassHammingDistance,
    MultilabelHammingDistance,
)
from torchmetrics_tpu_torch.classification.hinge import BinaryHingeLoss, HingeLoss, MulticlassHingeLoss
from torchmetrics_tpu_torch.classification.jaccard import (
    BinaryJaccardIndex,
    JaccardIndex,
    MulticlassJaccardIndex,
    MultilabelJaccardIndex,
)
from torchmetrics_tpu_torch.classification.matthews_corrcoef import (
    BinaryMatthewsCorrCoef,
    MatthewsCorrCoef,
    MulticlassMatthewsCorrCoef,
    MultilabelMatthewsCorrCoef,
)
from torchmetrics_tpu_torch.classification.negative_predictive_value import (
    BinaryNegativePredictiveValue,
    MulticlassNegativePredictiveValue,
    MultilabelNegativePredictiveValue,
    NegativePredictiveValue,
)
from torchmetrics_tpu_torch.classification.precision_recall import (
    BinaryPrecision,
    BinaryRecall,
    MulticlassPrecision,
    MulticlassRecall,
    MultilabelPrecision,
    MultilabelRecall,
    Precision,
    Recall,
)
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    PrecisionRecallCurve,
)
from torchmetrics_tpu_torch.classification.ranking import (
    MultilabelCoverageError,
    MultilabelRankingAveragePrecision,
    MultilabelRankingLoss,
)
from torchmetrics_tpu_torch.classification.roc import ROC, BinaryROC, MulticlassROC, MultilabelROC
from torchmetrics_tpu_torch.classification.specificity import (
    BinarySpecificity,
    MulticlassSpecificity,
    MultilabelSpecificity,
    Specificity,
)
from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    StatScores,
)

__all__ = [
    "Accuracy",
    "AUROC",
    "AveragePrecision",
    "BinaryAccuracy",
    "BinaryAUROC",
    "BinaryAveragePrecision",
    "BinaryCalibrationError",
    "BinaryCohenKappa",
    "BinaryConfusionMatrix",
    "BinaryF1Score",
    "BinaryFairness",
    "BinaryFBetaScore",
    "BinaryGroupStatRates",
    "BinaryHammingDistance",
    "BinaryHingeLoss",
    "BinaryJaccardIndex",
    "BinaryMatthewsCorrCoef",
    "BinaryNegativePredictiveValue",
    "BinaryPrecision",
    "BinaryPrecisionAtFixedRecall",
    "BinaryPrecisionRecallCurve",
    "BinaryRecall",
    "BinaryRecallAtFixedPrecision",
    "BinaryROC",
    "BinarySensitivityAtSpecificity",
    "BinarySpecificity",
    "BinarySpecificityAtSensitivity",
    "BinaryStatScores",
    "CalibrationError",
    "CohenKappa",
    "ConfusionMatrix",
    "Dice",
    "ExactMatch",
    "F1Score",
    "FBetaScore",
    "HammingDistance",
    "HingeLoss",
    "JaccardIndex",
    "MatthewsCorrCoef",
    "MulticlassAccuracy",
    "MulticlassAUROC",
    "MulticlassAveragePrecision",
    "MulticlassCalibrationError",
    "MulticlassCohenKappa",
    "MulticlassConfusionMatrix",
    "MulticlassExactMatch",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassHammingDistance",
    "MulticlassHingeLoss",
    "MulticlassJaccardIndex",
    "MulticlassMatthewsCorrCoef",
    "MulticlassNegativePredictiveValue",
    "MulticlassPrecision",
    "MulticlassPrecisionAtFixedRecall",
    "MulticlassPrecisionRecallCurve",
    "MulticlassRecall",
    "MulticlassRecallAtFixedPrecision",
    "MulticlassROC",
    "MulticlassSensitivityAtSpecificity",
    "MulticlassSpecificity",
    "MulticlassSpecificityAtSensitivity",
    "MulticlassStatScores",
    "MultilabelAccuracy",
    "MultilabelAUROC",
    "MultilabelAveragePrecision",
    "MultilabelConfusionMatrix",
    "MultilabelCoverageError",
    "MultilabelExactMatch",
    "MultilabelF1Score",
    "MultilabelFBetaScore",
    "MultilabelHammingDistance",
    "MultilabelJaccardIndex",
    "MultilabelMatthewsCorrCoef",
    "MultilabelNegativePredictiveValue",
    "MultilabelPrecision",
    "MultilabelPrecisionAtFixedRecall",
    "MultilabelPrecisionRecallCurve",
    "MultilabelRankingAveragePrecision",
    "MultilabelRankingLoss",
    "MultilabelRecall",
    "MultilabelRecallAtFixedPrecision",
    "MultilabelROC",
    "MultilabelSensitivityAtSpecificity",
    "MultilabelSpecificity",
    "MultilabelSpecificityAtSensitivity",
    "MultilabelStatScores",
    "NegativePredictiveValue",
    "Precision",
    "PrecisionAtFixedRecall",
    "PrecisionRecallCurve",
    "Recall",
    "RecallAtFixedPrecision",
    "ROC",
    "SensitivityAtSpecificity",
    "Specificity",
    "SpecificityAtSensitivity",
    "StatScores",
]
