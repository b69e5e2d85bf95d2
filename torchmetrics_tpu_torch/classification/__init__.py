"""Classification metrics of the port: the stat-scores and confusion-matrix families for
the three tasks, and the multiclass curves."""

from torchmetrics_tpu_torch.classification.accuracy import (
    Accuracy,
    BinaryAccuracy,
    MulticlassAccuracy,
    MultilabelAccuracy,
)
from torchmetrics_tpu_torch.classification.auroc import AUROC, MulticlassAUROC
from torchmetrics_tpu_torch.classification.average_precision import AveragePrecision, MulticlassAveragePrecision
from torchmetrics_tpu_torch.classification.cohen_kappa import BinaryCohenKappa, CohenKappa, MulticlassCohenKappa
from torchmetrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    ConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
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
from torchmetrics_tpu_torch.classification.hamming import (
    BinaryHammingDistance,
    HammingDistance,
    MulticlassHammingDistance,
    MultilabelHammingDistance,
)
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
    MulticlassPrecisionRecallCurve,
    PrecisionRecallCurve,
)
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
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BinaryAccuracy",
    "BinaryCohenKappa",
    "BinaryConfusionMatrix",
    "BinaryF1Score",
    "BinaryFBetaScore",
    "BinaryHammingDistance",
    "BinaryJaccardIndex",
    "BinaryMatthewsCorrCoef",
    "BinaryNegativePredictiveValue",
    "BinaryPrecision",
    "BinaryRecall",
    "BinarySpecificity",
    "BinaryStatScores",
    "CohenKappa",
    "ConfusionMatrix",
    "F1Score",
    "FBetaScore",
    "HammingDistance",
    "JaccardIndex",
    "MatthewsCorrCoef",
    "MulticlassAUROC",
    "MulticlassAccuracy",
    "MulticlassAveragePrecision",
    "MulticlassCohenKappa",
    "MulticlassConfusionMatrix",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassHammingDistance",
    "MulticlassJaccardIndex",
    "MulticlassMatthewsCorrCoef",
    "MulticlassNegativePredictiveValue",
    "MulticlassPrecision",
    "MulticlassPrecisionRecallCurve",
    "MulticlassRecall",
    "MulticlassSpecificity",
    "MulticlassStatScores",
    "MultilabelAccuracy",
    "MultilabelConfusionMatrix",
    "MultilabelF1Score",
    "MultilabelFBetaScore",
    "MultilabelHammingDistance",
    "MultilabelJaccardIndex",
    "MultilabelMatthewsCorrCoef",
    "MultilabelNegativePredictiveValue",
    "MultilabelPrecision",
    "MultilabelRecall",
    "MultilabelSpecificity",
    "MultilabelStatScores",
    "NegativePredictiveValue",
    "Precision",
    "PrecisionRecallCurve",
    "Recall",
    "Specificity",
    "StatScores",
]
