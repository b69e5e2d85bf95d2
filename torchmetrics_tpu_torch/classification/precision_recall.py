"""Precision and recall for the three tasks (counterpart of ``torchmetrics_tpu/classification/precision_recall.py``)."""

from torchmetrics_tpu_torch.classification._factory import make_stat_metric_classes

BinaryPrecision, MulticlassPrecision, MultilabelPrecision, Precision = make_stat_metric_classes(
    "precision", "BinaryPrecision", "MulticlassPrecision", "MultilabelPrecision", "Precision", __name__
)

BinaryRecall, MulticlassRecall, MultilabelRecall, Recall = make_stat_metric_classes(
    "recall", "BinaryRecall", "MulticlassRecall", "MultilabelRecall", "Recall", __name__
)

BinaryPrecision.__doc__ = """Binary precision: TP / (TP + FP).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import BinaryPrecision
    >>> metric = BinaryPrecision(device="cpu")
    >>> metric.update(torch.tensor([0.2, 0.8, 0.6, 0.3]), torch.tensor([0, 1, 0, 1]))
    >>> round(float(metric.compute()), 4)
    0.5
"""

BinaryRecall.__doc__ = """Binary recall: TP / (TP + FN)."""
