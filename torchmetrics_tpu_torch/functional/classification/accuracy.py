"""Accuracy (counterpart of ``torchmetrics_tpu/functional/classification/accuracy.py``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.accuracy import binary_accuracy
    >>> round(float(binary_accuracy(torch.tensor([0.1, 0.9, 0.8, 0.3]), torch.tensor([0, 1, 1, 1]))), 4)
    0.75
"""

from torchmetrics_tpu_torch.functional.classification._family import (
    _binary_stat_metric,
    _dispatch_stat_metric,
    _multiclass_stat_metric,
    _multilabel_stat_metric,
)


def binary_accuracy(preds, target, threshold=0.5, multidim_average="global", ignore_index=None, validate_args=True):
    return _binary_stat_metric("accuracy", preds, target, threshold, multidim_average, ignore_index, validate_args)


def multiclass_accuracy(preds, target, num_classes, average="macro", top_k=1, multidim_average="global",
                        ignore_index=None, validate_args=True):
    return _multiclass_stat_metric("accuracy", preds, target, num_classes, average, top_k, multidim_average,
                                   ignore_index, validate_args)


def multilabel_accuracy(preds, target, num_labels, threshold=0.5, average="macro", multidim_average="global",
                        ignore_index=None, validate_args=True):
    return _multilabel_stat_metric("accuracy", preds, target, num_labels, threshold, average, multidim_average,
                                   ignore_index, validate_args)


def accuracy(preds, target, task, threshold=0.5, num_classes=None, num_labels=None, average="micro",
             multidim_average="global", top_k=1, ignore_index=None, validate_args=True):
    return _dispatch_stat_metric("accuracy", preds, target, task, threshold, num_classes, num_labels, average,
                                 multidim_average, top_k, ignore_index, validate_args)
