"""Task-string dispatch base (counterpart of ``torchmetrics_tpu/classification/base.py``).

``Accuracy(task="multiclass", num_classes=5)`` returns a
``MulticlassAccuracy`` instance from ``__new__``. The port has the
multiclass family only so far; other tasks raise.
"""

from __future__ import annotations

from typing import Any

from torchmetrics_tpu_torch.core.metric import Metric


class _ClassificationTaskWrapper(Metric):
    """Base for wrapper classes that dispatch to task-specific metrics in ``__new__``."""

    def __new__(cls, task: Any = None, *args: Any, **kwargs: Any) -> "Metric":
        task = kwargs.pop("task", task)
        return cls._create_task_metric(task, *args, **kwargs)

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        raise NotImplementedError


def _multiclass_only(task: Any, name: str) -> None:
    if str(task) in ("binary", "multilabel"):
        raise ValueError(f"{name}(task={task!r}) is not ported yet: the PyTorch port has the multiclass task only")
    if str(task) != "multiclass":
        raise ValueError(f"Task {task} not supported!")
