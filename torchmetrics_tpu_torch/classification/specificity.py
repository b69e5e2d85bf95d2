"""Specificity for the three tasks (counterpart of ``torchmetrics_tpu/classification/specificity.py``)."""

from torchmetrics_tpu_torch.classification._factory import make_stat_metric_classes

BinarySpecificity, MulticlassSpecificity, MultilabelSpecificity, Specificity = make_stat_metric_classes(
    "specificity", "BinarySpecificity", "MulticlassSpecificity", "MultilabelSpecificity", "Specificity", __name__
)

BinarySpecificity.__doc__ = """Binary specificity: TN / (TN + FP)."""
