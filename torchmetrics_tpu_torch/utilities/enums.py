"""String-enum task and average types (counterpart of ``torchmetrics_tpu/utilities/enums.py``).

These enums drive the task-string dispatch
(``task="binary"|"multiclass"|"multilabel"``) and the ``average=`` argument
validation. The module holds no tensor code, so it is the JAX package's
file with its imports unchanged.

Example::

    >>> from torchmetrics_tpu_torch.utilities.enums import ClassificationTask, DataType
    >>> ClassificationTask.from_str("multiclass"), str(DataType.MULTILABEL)
    (<ClassificationTask.MULTICLASS: 'multiclass'>, 'multi-label')
"""

from __future__ import annotations

from enum import Enum
from typing import Optional


class EnumStr(str, Enum):
    """Base string enum with forgiving ``from_str`` lookup."""

    @staticmethod
    def _name() -> str:
        return "Task"

    @classmethod
    def from_str(cls, value: str, source: str = "Key") -> "EnumStr":
        try:
            return cls(value.lower().replace("-", "_"))
        except ValueError as err:
            valid = [m.value for m in cls]
            raise ValueError(
                f"Invalid {cls._name()}: expected one of {valid}, but got {value}."
            ) from err

    def __str__(self) -> str:
        return self.value


class DataType(EnumStr):
    """Type of an input tensor as inferred by the input checks."""

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"

    @classmethod
    def from_str(cls, value: str, source: str = "Key") -> "DataType":  # type: ignore[override]
        try:
            return cls(value.lower())
        except ValueError as err:
            valid = [m.value for m in cls]
            raise ValueError(
                f"Invalid DataType: expected one of {valid}, but got {value}."
            ) from err


class AverageMethod(EnumStr):
    """Reduction over classes: micro/macro/weighted/none/samples."""

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = "none"
    SAMPLES = "samples"


class MDMCAverageMethod(EnumStr):
    """Multi-dim multi-class averaging."""

    GLOBAL = "global"
    SAMPLEWISE = "samplewise"


class ClassificationTask(EnumStr):
    """binary | multiclass | multilabel."""

    BINARY = "binary"
    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"


class ClassificationTaskNoBinary(EnumStr):
    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"


class ClassificationTaskNoMultilabel(EnumStr):
    BINARY = "binary"
    MULTICLASS = "multiclass"


def _check_average_arg(average: Optional[str], allowed=("micro", "macro", "weighted", "none", None)) -> None:
    if average not in allowed:
        raise ValueError(f"The `average` has to be one of {allowed}, got {average}.")
