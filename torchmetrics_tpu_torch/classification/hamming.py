"""Hamming distance for the three tasks (counterpart of ``torchmetrics_tpu/classification/hamming.py``)."""

from torchmetrics_tpu_torch.classification._factory import make_stat_metric_classes

BinaryHammingDistance, MulticlassHammingDistance, MultilabelHammingDistance, HammingDistance = (
    make_stat_metric_classes(
        "hamming", "BinaryHammingDistance", "MulticlassHammingDistance", "MultilabelHammingDistance",
        "HammingDistance", __name__, higher_is_better=False,
    )
)

BinaryHammingDistance.__doc__ = """Binary Hamming distance: the share of labels that disagree."""
