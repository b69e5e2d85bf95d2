"""Task-string dispatch base (counterpart of ``torchmetrics_tpu/classification/base.py``).

``Accuracy(task="multiclass", num_classes=5)`` returns a
``MulticlassAccuracy`` instance from ``__new__``.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

from torchmetrics_tpu_torch.core.metric import Metric


class _ClassificationTaskWrapper(Metric):
    """Base for wrapper classes that dispatch to task-specific metrics in ``__new__``."""

    def __new__(cls, task: Any = None, *args: Any, **kwargs: Any) -> "Metric":
        task = kwargs.pop("task", task)
        return cls._create_task_metric(task, *args, **kwargs)

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        raise NotImplementedError


# the kwargs a task wrapper drops before it builds the stat-scores family's task class
STAT_DROPS: Dict[str, Tuple[str, ...]] = {
    "binary": ("num_classes", "num_labels", "average", "top_k"),
    "multiclass": ("threshold", "num_labels"),
    "multilabel": ("num_classes", "top_k"),
}


def _dispatch_task(
    task: Any, classes: Dict[str, type], drops: Dict[str, Tuple[str, ...]], args: Sequence, kwargs: Dict[str, Any]
) -> Metric:
    """``classes[task](*args, **kwargs)`` without the kwargs ``drops[task]`` names."""
    task = str(task)
    if task not in classes:
        raise ValueError(f"Task {task} not supported!")
    return classes[task](*args, **{k: v for k, v in kwargs.items() if k not in drops.get(task, ())})

