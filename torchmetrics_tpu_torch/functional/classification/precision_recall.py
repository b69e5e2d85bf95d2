"""Precision and recall (counterpart of ``torchmetrics_tpu/functional/classification/precision_recall.py``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.precision_recall import binary_precision
    >>> round(float(binary_precision(torch.tensor([0.1, 0.9, 0.8, 0.3]), torch.tensor([0, 1, 0, 1]))), 4)
    0.5
"""

from torchmetrics_tpu_torch.functional.classification._family import (
    _binary_stat_metric,
    _dispatch_stat_metric,
    _multiclass_stat_metric,
    _multilabel_stat_metric,
)


def binary_precision(preds, target, threshold=0.5, multidim_average="global", ignore_index=None, validate_args=True,
                     zero_division=0.0):
    return _binary_stat_metric("precision", preds, target, threshold, multidim_average, ignore_index, validate_args,
                               zero_division=zero_division)


def multiclass_precision(preds, target, num_classes, average="macro", top_k=1, multidim_average="global",
                         ignore_index=None, validate_args=True, zero_division=0.0):
    return _multiclass_stat_metric("precision", preds, target, num_classes, average, top_k, multidim_average,
                                   ignore_index, validate_args, zero_division=zero_division)


def multilabel_precision(preds, target, num_labels, threshold=0.5, average="macro", multidim_average="global",
                         ignore_index=None, validate_args=True, zero_division=0.0):
    return _multilabel_stat_metric("precision", preds, target, num_labels, threshold, average, multidim_average,
                                   ignore_index, validate_args, zero_division=zero_division)


def binary_recall(preds, target, threshold=0.5, multidim_average="global", ignore_index=None, validate_args=True,
                  zero_division=0.0):
    return _binary_stat_metric("recall", preds, target, threshold, multidim_average, ignore_index, validate_args,
                               zero_division=zero_division)


def multiclass_recall(preds, target, num_classes, average="macro", top_k=1, multidim_average="global",
                      ignore_index=None, validate_args=True, zero_division=0.0):
    return _multiclass_stat_metric("recall", preds, target, num_classes, average, top_k, multidim_average,
                                   ignore_index, validate_args, zero_division=zero_division)


def multilabel_recall(preds, target, num_labels, threshold=0.5, average="macro", multidim_average="global",
                      ignore_index=None, validate_args=True, zero_division=0.0):
    return _multilabel_stat_metric("recall", preds, target, num_labels, threshold, average, multidim_average,
                                   ignore_index, validate_args, zero_division=zero_division)


def precision(preds, target, task, threshold=0.5, num_classes=None, num_labels=None, average="micro",
              multidim_average="global", top_k=1, ignore_index=None, validate_args=True, zero_division=0.0):
    return _dispatch_stat_metric("precision", preds, target, task, threshold, num_classes, num_labels, average,
                                 multidim_average, top_k, ignore_index, validate_args, zero_division=zero_division)


def recall(preds, target, task, threshold=0.5, num_classes=None, num_labels=None, average="micro",
           multidim_average="global", top_k=1, ignore_index=None, validate_args=True, zero_division=0.0):
    return _dispatch_stat_metric("recall", preds, target, task, threshold, num_classes, num_labels, average,
                                 multidim_average, top_k, ignore_index, validate_args, zero_division=zero_division)
