"""Task-string dispatch base (counterpart of ``torchmetrics_tpu/classification/base.py``).

``Accuracy(task="multiclass", num_classes=5)`` returns a
``MulticlassAccuracy`` instance from ``__new__``. The curve family (AUROC,
average precision, PR curve) has the multiclass task only so far; its other
tasks raise.
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


def _multiclass_only(task: Any, name: str) -> None:
    if str(task) in ("binary", "multilabel"):
        raise ValueError(f"{name}(task={task!r}) is not ported yet: the PyTorch port has the multiclass task only")
    if str(task) != "multiclass":
        raise ValueError(f"Task {task} not supported!")
