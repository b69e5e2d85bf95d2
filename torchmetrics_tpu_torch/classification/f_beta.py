"""F-beta and F1 for the three tasks (counterpart of ``torchmetrics_tpu/classification/f_beta.py``)."""

from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import STAT_DROPS, _ClassificationTaskWrapper, _dispatch_task
from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
)
from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification.f_beta import _validate_beta


class BinaryFBetaScore(BinaryStatScores):
    _stat_kind = "fbeta"
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, beta: float, threshold: float = 0.5, multidim_average: str = "global",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(threshold=threshold, multidim_average=multidim_average,
                         ignore_index=ignore_index, validate_args=validate_args, **kwargs)
        if validate_args:
            _validate_beta(beta)
        self.beta = self._beta = beta

    def _compute(self, state: State):
        return self._reduce_kind(state, "binary")


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


class MultilabelFBetaScore(MultilabelStatScores):
    _stat_kind = "fbeta"
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(self, beta: float, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
                 multidim_average: str = "global", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels=num_labels, threshold=threshold, average=average,
                         multidim_average=multidim_average, ignore_index=ignore_index,
                         validate_args=validate_args, **kwargs)
        if validate_args:
            _validate_beta(beta)
        self.beta = self._beta = beta

    def _compute(self, state: State):
        return self._reduce_kind(state, self.average)


class BinaryF1Score(BinaryFBetaScore):
    """Binary F1.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryF1Score
        >>> metric = BinaryF1Score(device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.8, 0.6, 0.3]), torch.tensor([0, 1, 0, 1]))
        >>> round(float(metric.compute()), 4)
        0.5
    """

    def __init__(self, threshold: float = 0.5, multidim_average: str = "global",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(1.0, threshold, multidim_average, ignore_index, validate_args, **kwargs)


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


class MultilabelF1Score(MultilabelFBetaScore):
    def __init__(self, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
                 multidim_average: str = "global", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(1.0, num_labels, threshold, average, multidim_average, ignore_index, validate_args, **kwargs)


class FBetaScore(_ClassificationTaskWrapper):
    """Task dispatch: ``FBetaScore(task=..., beta=..., ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        classes = {"binary": BinaryFBetaScore, "multiclass": MulticlassFBetaScore, "multilabel": MultilabelFBetaScore}
        return _dispatch_task(task, classes, STAT_DROPS, args, kwargs)


class F1Score(_ClassificationTaskWrapper):
    """Task dispatch: ``F1Score(task=..., ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        classes = {"binary": BinaryF1Score, "multiclass": MulticlassF1Score, "multilabel": MultilabelF1Score}
        return _dispatch_task(task, classes, STAT_DROPS, args, kwargs)
