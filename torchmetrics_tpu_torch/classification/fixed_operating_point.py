"""Fixed-operating-point metric classes (counterpart of ``torchmetrics_tpu/classification/fixed_operating_point.py``).

Each class is a curve metric of the port (its state and update, exact or
binned, so ``binned_confmat_multiclass`` and ``binned_confmat_multilabel``
on the card with integer ``thresholds``) whose compute takes the curve to
the host once and picks the operating point there, as the JAX classes do.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.classification import PrecisionAtFixedRecall
    >>> metric = PrecisionAtFixedRecall(task="binary", min_recall=0.5, device="cpu")
    >>> metric.update(torch.tensor([0.1, 0.4, 0.6, 0.85]), torch.tensor([0, 1, 0, 1]))
    >>> prec, thresh = metric.compute()
    >>> (round(float(prec), 4), round(float(thresh), 4))
    (1.0, 0.85)
"""

from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
)
from torchmetrics_tpu_torch.classification.roc import BinaryROC, MulticlassROC, MultilabelROC
from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.fixed_operating_point import (
    _best_at_constraint,
    _complement,
    _per_class,
    _validate_min,
)


def _make_fixed_point_classes(curve_bases, objective_idx: int, constraint_idx: int, min_arg: str, roc_based: bool):
    """Binary, multiclass and multilabel classes of one fixed-point metric.

    ``objective_idx`` and ``constraint_idx`` pick from the curve's
    (precision, recall, thresholds), or from (fpr -> specificity, tpr, thresholds).
    """
    binary_base, multiclass_base, multilabel_base = curve_bases

    def _extract(curve, idx):
        return _complement(curve[idx]) if roc_based and idx == 0 else curve[idx]

    def _point(self, curve, n: Optional[int]):
        obj, con = _extract(curve, objective_idx), _extract(curve, constraint_idx)
        if n is None:
            return _best_at_constraint(obj, con, curve[2], self.min_value, zero_sentinel=not roc_based)
        return _per_class(obj, con, curve[2], self.min_value, n, zero_sentinel=not roc_based)

    class _Binary(binary_base):  # type: ignore[misc, valid-type]
        def __init__(self, min_value: float, thresholds=None, ignore_index=None,
                     validate_args: bool = True, **kwargs: Any) -> None:
            super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=validate_args, **kwargs)
            if validate_args:
                _validate_min(min_arg, min_value)
            self.min_value = min_value

        def _compute(self, state: State):
            return _point(self, super()._compute(state), None)

    class _Multiclass(multiclass_base):  # type: ignore[misc, valid-type]
        def __init__(self, num_classes: int, min_value: float, thresholds=None,
                     ignore_index=None, validate_args: bool = True, **kwargs: Any) -> None:
            super().__init__(num_classes=num_classes, thresholds=thresholds,
                             ignore_index=ignore_index, validate_args=validate_args, **kwargs)
            if validate_args:
                _validate_min(min_arg, min_value)
            self.min_value = min_value

        def _compute(self, state: State):
            return _point(self, super()._compute(state), self.num_classes)

    class _Multilabel(multilabel_base):  # type: ignore[misc, valid-type]
        def __init__(self, num_labels: int, min_value: float, thresholds=None,
                     ignore_index=None, validate_args: bool = True, **kwargs: Any) -> None:
            super().__init__(num_labels=num_labels, thresholds=thresholds,
                             ignore_index=ignore_index, validate_args=validate_args, **kwargs)
            if validate_args:
                _validate_min(min_arg, min_value)
            self.min_value = min_value

        def _compute(self, state: State):
            return _point(self, super()._compute(state), self.num_labels)

    return _Binary, _Multiclass, _Multilabel


_PRC_BASES = (BinaryPrecisionRecallCurve, MulticlassPrecisionRecallCurve, MultilabelPrecisionRecallCurve)
_ROC_BASES = (BinaryROC, MulticlassROC, MultilabelROC)

# precision@recall: curve = (precision, recall, thr); objective 0, constraint 1
(BinaryPrecisionAtFixedRecall, MulticlassPrecisionAtFixedRecall, MultilabelPrecisionAtFixedRecall) = (
    _make_fixed_point_classes(_PRC_BASES, 0, 1, "min_recall", roc_based=False)
)
# recall@precision: objective 1, constraint 0
(BinaryRecallAtFixedPrecision, MulticlassRecallAtFixedPrecision, MultilabelRecallAtFixedPrecision) = (
    _make_fixed_point_classes(_PRC_BASES, 1, 0, "min_precision", roc_based=False)
)
# sensitivity@specificity: curve = (fpr, tpr, thr); objective tpr (1), constraint specificity (0)
(BinarySensitivityAtSpecificity, MulticlassSensitivityAtSpecificity, MultilabelSensitivityAtSpecificity) = (
    _make_fixed_point_classes(_ROC_BASES, 1, 0, "min_specificity", roc_based=True)
)
# specificity@sensitivity: objective specificity (0), constraint tpr (1)
(BinarySpecificityAtSensitivity, MulticlassSpecificityAtSensitivity, MultilabelSpecificityAtSensitivity) = (
    _make_fixed_point_classes(_ROC_BASES, 0, 1, "min_sensitivity", roc_based=True)
)

for _cls, _name in [
    (BinaryPrecisionAtFixedRecall, "BinaryPrecisionAtFixedRecall"),
    (MulticlassPrecisionAtFixedRecall, "MulticlassPrecisionAtFixedRecall"),
    (MultilabelPrecisionAtFixedRecall, "MultilabelPrecisionAtFixedRecall"),
    (BinaryRecallAtFixedPrecision, "BinaryRecallAtFixedPrecision"),
    (MulticlassRecallAtFixedPrecision, "MulticlassRecallAtFixedPrecision"),
    (MultilabelRecallAtFixedPrecision, "MultilabelRecallAtFixedPrecision"),
    (BinarySensitivityAtSpecificity, "BinarySensitivityAtSpecificity"),
    (MulticlassSensitivityAtSpecificity, "MulticlassSensitivityAtSpecificity"),
    (MultilabelSensitivityAtSpecificity, "MultilabelSensitivityAtSpecificity"),
    (BinarySpecificityAtSensitivity, "BinarySpecificityAtSensitivity"),
    (MulticlassSpecificityAtSensitivity, "MulticlassSpecificityAtSensitivity"),
    (MultilabelSpecificityAtSensitivity, "MultilabelSpecificityAtSensitivity"),
]:
    _cls.__name__ = _name
    _cls.__qualname__ = _name


class _FixedPointTaskWrapper(_ClassificationTaskWrapper):
    _task_classes: dict = {}

    def __new__(cls, task: str, min_value: Optional[float] = None, thresholds=None,
                num_classes: Optional[int] = None, num_labels: Optional[int] = None,
                ignore_index=None, validate_args: bool = True, **kwargs: Any) -> Metric:
        if task == "binary":
            return cls._task_classes["binary"](min_value, thresholds, ignore_index, validate_args, **kwargs)
        if task == "multiclass":
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return cls._task_classes["multiclass"](num_classes, min_value, thresholds, ignore_index, validate_args,
                                                   **kwargs)
        if task == "multilabel":
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return cls._task_classes["multilabel"](num_labels, min_value, thresholds, ignore_index, validate_args,
                                                   **kwargs)
        raise ValueError(f"Task {task} not supported!")


class PrecisionAtFixedRecall(_FixedPointTaskWrapper):
    _task_classes = {"binary": BinaryPrecisionAtFixedRecall, "multiclass": MulticlassPrecisionAtFixedRecall,
                     "multilabel": MultilabelPrecisionAtFixedRecall}

    def __new__(cls, task: str, min_recall: Optional[float] = None, **kwargs: Any) -> Metric:
        return super().__new__(cls, task, min_value=min_recall, **kwargs)


class RecallAtFixedPrecision(_FixedPointTaskWrapper):
    _task_classes = {"binary": BinaryRecallAtFixedPrecision, "multiclass": MulticlassRecallAtFixedPrecision,
                     "multilabel": MultilabelRecallAtFixedPrecision}

    def __new__(cls, task: str, min_precision: Optional[float] = None, **kwargs: Any) -> Metric:
        return super().__new__(cls, task, min_value=min_precision, **kwargs)


class SensitivityAtSpecificity(_FixedPointTaskWrapper):
    _task_classes = {"binary": BinarySensitivityAtSpecificity, "multiclass": MulticlassSensitivityAtSpecificity,
                     "multilabel": MultilabelSensitivityAtSpecificity}

    def __new__(cls, task: str, min_specificity: Optional[float] = None, **kwargs: Any) -> Metric:
        return super().__new__(cls, task, min_value=min_specificity, **kwargs)


class SpecificityAtSensitivity(_FixedPointTaskWrapper):
    _task_classes = {"binary": BinarySpecificityAtSensitivity, "multiclass": MulticlassSpecificityAtSensitivity,
                     "multilabel": MultilabelSpecificityAtSensitivity}

    def __new__(cls, task: str, min_sensitivity: Optional[float] = None, **kwargs: Any) -> Metric:
        return super().__new__(cls, task, min_value=min_sensitivity, **kwargs)
