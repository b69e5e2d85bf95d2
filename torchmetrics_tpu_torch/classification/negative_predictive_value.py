"""Negative predictive value for the three tasks.

Counterpart of ``torchmetrics_tpu/classification/negative_predictive_value.py``.
"""

from torchmetrics_tpu_torch.classification._factory import make_stat_metric_classes

(
    BinaryNegativePredictiveValue,
    MulticlassNegativePredictiveValue,
    MultilabelNegativePredictiveValue,
    NegativePredictiveValue,
) = make_stat_metric_classes(
    "npv", "BinaryNegativePredictiveValue", "MulticlassNegativePredictiveValue",
    "MultilabelNegativePredictiveValue", "NegativePredictiveValue", __name__,
)
