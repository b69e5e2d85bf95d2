"""Specificity (counterpart of ``torchmetrics_tpu/functional/classification/specificity.py``)."""

from torchmetrics_tpu_torch.functional.classification._family import (
    _binary_stat_metric,
    _dispatch_stat_metric,
    _multiclass_stat_metric,
    _multilabel_stat_metric,
)


def binary_specificity(preds, target, threshold=0.5, multidim_average="global", ignore_index=None, validate_args=True):
    return _binary_stat_metric("specificity", preds, target, threshold, multidim_average, ignore_index, validate_args)


def multiclass_specificity(preds, target, num_classes, average="macro", top_k=1, multidim_average="global",
        ignore_index=None, validate_args=True):
    return _multiclass_stat_metric("specificity", preds, target, num_classes, average, top_k, multidim_average,
                                   ignore_index, validate_args)


def multilabel_specificity(preds, target, num_labels, threshold=0.5, average="macro", multidim_average="global",
        ignore_index=None, validate_args=True):
    return _multilabel_stat_metric("specificity", preds, target, num_labels, threshold, average, multidim_average,
                                   ignore_index, validate_args)


def specificity(preds, target, task, threshold=0.5, num_classes=None, num_labels=None, average="micro",
        multidim_average="global", top_k=1, ignore_index=None, validate_args=True):
    return _dispatch_stat_metric("specificity", preds, target, task, threshold, num_classes, num_labels, average,
                                 multidim_average, top_k, ignore_index, validate_args)
