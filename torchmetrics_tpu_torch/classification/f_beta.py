"""Multiclass F-beta and F1 (counterpart of ``torchmetrics_tpu/classification/f_beta.py``)."""

from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper, _multiclass_only
from torchmetrics_tpu_torch.classification.stat_scores import MulticlassStatScores
from torchmetrics_tpu_torch.core.metric import Metric, State


def _validate_beta(beta: float) -> None:
    if not (isinstance(beta, (int, float)) and beta > 0):
        raise ValueError(f"Expected argument `beta` to be a float larger than 0, but got {beta}.")


class MulticlassFBetaScore(MulticlassStatScores):
    """Multiclass F-beta score.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassFBetaScore
        >>> metric = MulticlassFBetaScore(beta=2.0, num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 2, 2]))
        >>> round(float(metric.compute()), 4)
        0.7963
    """

    _stat_kind = "fbeta"
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, beta: float, num_classes: int, top_k: int = 1, average: Optional[str] = "macro",
                 multidim_average: str = "global", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, top_k=top_k, average=average,
                         multidim_average=multidim_average, ignore_index=ignore_index,
                         validate_args=validate_args, **kwargs)
        if validate_args:
            _validate_beta(beta)
        self.beta = self._beta = beta

    def _compute(self, state: State):
        return self._reduce_kind(state, self.average)


class MulticlassF1Score(MulticlassFBetaScore):
    """Multiclass F1.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassF1Score
        >>> metric = MulticlassF1Score(num_classes=3, average='macro', device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 2, 2]))
        >>> round(float(metric.compute()), 4)
        0.7778
    """

    def __init__(self, num_classes: int, top_k: int = 1, average: Optional[str] = "macro",
                 multidim_average: str = "global", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(1.0, num_classes, top_k, average, multidim_average, ignore_index, validate_args, **kwargs)


class FBetaScore(_ClassificationTaskWrapper):
    """Task dispatch: ``FBetaScore(task="multiclass", beta=..., ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        _multiclass_only(task, cls.__name__)
        kwargs.pop("threshold", None)
        kwargs.pop("num_labels", None)
        return MulticlassFBetaScore(*args, **kwargs)


class F1Score(_ClassificationTaskWrapper):
    """Task dispatch: ``F1Score(task="multiclass", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        _multiclass_only(task, cls.__name__)
        kwargs.pop("threshold", None)
        kwargs.pop("num_labels", None)
        return MulticlassF1Score(*args, **kwargs)
