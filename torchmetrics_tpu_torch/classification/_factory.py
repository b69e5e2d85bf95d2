"""Class factory of the stat-scores family (counterpart of ``torchmetrics_tpu/classification/_factory.py``).

Each (kind, task) class is made once by ``type(...)`` with its own name and
the ``__module__`` of the module that binds it, so that pickling and
introspection treat it as a class written out by hand.
"""

from __future__ import annotations

from typing import Any, Tuple

from torchmetrics_tpu_torch.classification.base import STAT_DROPS, _ClassificationTaskWrapper, _dispatch_task
from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
)
from torchmetrics_tpu_torch.core.metric import Metric, State


def _binary_compute(self, state: State):
    return self._reduce_kind(state, "binary")


def _avg_compute(self, state: State):
    return self._reduce_kind(state, self.average)


def make_stat_metric_classes(
    kind: str,
    binary_name: str,
    multiclass_name: str,
    multilabel_name: str,
    wrapper_name: str,
    module: str,
    higher_is_better: bool = True,
) -> Tuple[type, type, type, type]:
    """Build the (Binary*, Multiclass*, Multilabel*, task wrapper) classes of a stat kind."""
    common = {
        "_stat_kind": kind,
        "is_differentiable": False,
        "higher_is_better": higher_is_better,
        "full_state_update": False,
        "__module__": module,
    }
    binary_cls = type(binary_name, (BinaryStatScores,), {**common, "_compute": _binary_compute})
    multiclass_cls = type(multiclass_name, (MulticlassStatScores,), {**common, "_compute": _avg_compute})
    multilabel_cls = type(multilabel_name, (MultilabelStatScores,), {**common, "_compute": _avg_compute})
    classes = {"binary": binary_cls, "multiclass": multiclass_cls, "multilabel": multilabel_cls}

    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        return _dispatch_task(task, classes, STAT_DROPS, args, kwargs)

    wrapper_cls = type(
        wrapper_name,
        (_ClassificationTaskWrapper,),
        {"__module__": module, "_create_task_metric": classmethod(_create_task_metric)},
    )
    return binary_cls, multiclass_cls, multilabel_cls, wrapper_cls
