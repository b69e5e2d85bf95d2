"""F-beta and F1 (counterpart of ``torchmetrics_tpu/functional/classification/f_beta.py``).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.functional.classification.f_beta import binary_f1_score
    >>> round(float(binary_f1_score(torch.tensor([0.1, 0.9, 0.8, 0.3]), torch.tensor([0, 1, 1, 1]))), 4)
    0.8
"""

from torchmetrics_tpu_torch.functional.classification._family import (
    _binary_stat_metric,
    _dispatch_stat_metric,
    _multiclass_stat_metric,
    _multilabel_stat_metric,
)


def _validate_beta(beta: float) -> None:
    if not (isinstance(beta, (int, float)) and beta > 0):
        raise ValueError(f"Expected argument `beta` to be a float larger than 0, but got {beta}.")


def binary_fbeta_score(preds, target, beta, threshold=0.5, multidim_average="global", ignore_index=None,
                       validate_args=True, zero_division=0.0):
    if validate_args:
        _validate_beta(beta)
    return _binary_stat_metric("fbeta", preds, target, threshold, multidim_average, ignore_index, validate_args,
                               beta=beta, zero_division=zero_division)


def multiclass_fbeta_score(preds, target, beta, num_classes, average="macro", top_k=1, multidim_average="global",
                           ignore_index=None, validate_args=True, zero_division=0.0):
    if validate_args:
        _validate_beta(beta)
    return _multiclass_stat_metric("fbeta", preds, target, num_classes, average, top_k, multidim_average,
                                   ignore_index, validate_args, beta=beta, zero_division=zero_division)


def multilabel_fbeta_score(preds, target, beta, num_labels, threshold=0.5, average="macro",
                           multidim_average="global", ignore_index=None, validate_args=True, zero_division=0.0):
    if validate_args:
        _validate_beta(beta)
    return _multilabel_stat_metric("fbeta", preds, target, num_labels, threshold, average, multidim_average,
                                   ignore_index, validate_args, beta=beta, zero_division=zero_division)


def binary_f1_score(preds, target, threshold=0.5, multidim_average="global", ignore_index=None, validate_args=True,
                    zero_division=0.0):
    return binary_fbeta_score(preds, target, 1.0, threshold, multidim_average, ignore_index, validate_args,
                              zero_division)


def multiclass_f1_score(preds, target, num_classes, average="macro", top_k=1, multidim_average="global",
                        ignore_index=None, validate_args=True, zero_division=0.0):
    return multiclass_fbeta_score(preds, target, 1.0, num_classes, average, top_k, multidim_average, ignore_index,
                                  validate_args, zero_division)


def multilabel_f1_score(preds, target, num_labels, threshold=0.5, average="macro", multidim_average="global",
                        ignore_index=None, validate_args=True, zero_division=0.0):
    return multilabel_fbeta_score(preds, target, 1.0, num_labels, threshold, average, multidim_average,
                                  ignore_index, validate_args, zero_division)


def fbeta_score(preds, target, task, beta=1.0, threshold=0.5, num_classes=None, num_labels=None, average="micro",
                multidim_average="global", top_k=1, ignore_index=None, validate_args=True, zero_division=0.0):
    if validate_args:
        _validate_beta(beta)
    return _dispatch_stat_metric("fbeta", preds, target, task, threshold, num_classes, num_labels, average,
                                 multidim_average, top_k, ignore_index, validate_args, beta=beta,
                                 zero_division=zero_division)


def f1_score(preds, target, task, threshold=0.5, num_classes=None, num_labels=None, average="micro",
             multidim_average="global", top_k=1, ignore_index=None, validate_args=True, zero_division=0.0):
    return fbeta_score(preds, target, task, 1.0, threshold, num_classes, num_labels, average, multidim_average,
                       top_k, ignore_index, validate_args, zero_division)
