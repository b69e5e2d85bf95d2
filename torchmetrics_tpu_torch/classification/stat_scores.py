"""Stat-scores base class and the ``StatScores`` family for the three tasks.

Counterpart of ``torchmetrics_tpu/classification/stat_scores.py``. Under
``global`` averaging the tp/fp/tn/fn states are int32 arrays with ``sum``
reduction; under ``samplewise`` they are lists of per-sample stats.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.classification.base import STAT_DROPS, _ClassificationTaskWrapper, _dispatch_task
from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.classification._reduce import _stat_reduce
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _binary_format,
    _binary_stat_scores_update,
    _binary_validate_args,
    _indicator_stat_scores,
    _multiclass_indicators,
    _multiclass_validate_args,
    _multilabel_format,
    _multilabel_stat_scores_update,
    _multilabel_validate_args,
    _stack_stats,
)
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class _AbstractStatScores(Metric):
    """Shared state management for the stat-scores tower."""

    _stat_kind: str = "stat_scores"  # overridden by subclasses (accuracy, fbeta, ...)
    _beta: float = 1.0
    _multilabel: bool = False

    def _create_state(self, size: int, multidim_average: str) -> None:
        if multidim_average == "samplewise":
            for name in ("tp", "fp", "tn", "fn"):
                self.add_state(name, [], dist_reduce_fx="cat")
            return
        # int32, as in the JAX package: torch's default int64 must not leak
        # into the state, and a float32 counter stops at 2**24
        shape = (size,) if size > 1 else ()
        default = torch.zeros(shape, dtype=torch.int32)
        for name in ("tp", "fp", "tn", "fn"):
            self.add_state(name, default, dist_reduce_fx="sum", value_range=(0.0, float("inf")))

    def _update_stats(self, state: State, tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> State:
        if self.multidim_average == "samplewise":
            return {
                "tp": tuple(state["tp"]) + (tp,),
                "fp": tuple(state["fp"]) + (fp,),
                "tn": tuple(state["tn"]) + (tn,),
                "fn": tuple(state["fn"]) + (fn,),
            }
        dtype = state["tp"].dtype
        return {
            "tp": state["tp"] + tp.to(dtype),
            "fp": state["fp"] + fp.to(dtype),
            "tn": state["tn"] + tn.to(dtype),
            "fn": state["fn"] + fn.to(dtype),
        }

    def _final_state(self, state: State) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        if self.multidim_average == "samplewise":
            return tuple(dim_zero_cat(state[k]) for k in ("tp", "fp", "tn", "fn"))
        return state["tp"], state["fp"], state["tn"], state["fn"]

    def _reduce_kind(self, state: State, average: Optional[str]) -> Tensor:
        tp, fp, tn, fn = self._final_state(state)
        return _stat_reduce(
            self._stat_kind, tp, fp, tn, fn,
            average=average, multilabel=self._multilabel, beta=self._beta,
            top_k=getattr(self, "top_k", 1), zero_division=getattr(self, "zero_division", 0.0),
        )


class BinaryStatScores(_AbstractStatScores):
    """Binary tp/fp/tn/fn.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryStatScores
        >>> metric = BinaryStatScores(device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.8, 0.6, 0.3]), torch.tensor([0, 1, 0, 1]))
        >>> metric.compute().tolist()  # tp, fp, tn, fn, support
        [1, 1, 1, 1, 2]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_validate_args(threshold, multidim_average, ignore_index)
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.zero_division = zero_division
        self._create_state(1, multidim_average)

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        p, t, v = _binary_format(self._tensor(preds), self._tensor(target), self.threshold, self.ignore_index)
        return self._update_stats(state, *_binary_stat_scores_update(p, t, v, self.multidim_average))

    def _compute(self, state: State) -> Tensor:
        return _stack_stats(self._final_state(state))


class MulticlassStatScores(_AbstractStatScores):
    """Multiclass per-class tp/fp/tn/fn.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassStatScores
        >>> metric = MulticlassStatScores(num_classes=3, average="micro", device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 2, 2]))
        >>> metric.compute()  # tp, fp, tn, fn, support
        tensor([3, 1, 7, 1, 4], dtype=torch.int32)
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False

    def __init__(
        self,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_validate_args(num_classes, top_k, average, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.top_k = top_k
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.zero_division = zero_division
        self._create_state(num_classes, multidim_average)

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        pred_ind, targ_ind, valid = _multiclass_indicators(
            self._tensor(preds), self._tensor(target), self.num_classes, self.top_k, self.ignore_index
        )
        tp, fp, tn, fn = _indicator_stat_scores(pred_ind, targ_ind, valid, self.multidim_average)
        return self._update_stats(state, tp, fp, tn, fn)

    def _compute(self, state: State) -> Tensor:
        return _stack_stats(self._final_state(state), self.average)


class MultilabelStatScores(_AbstractStatScores):
    """Multilabel per-label tp/fp/tn/fn.

    Example::

        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MultilabelStatScores
        >>> metric = MultilabelStatScores(num_labels=3, average="micro", device="cpu")
        >>> metric.update(torch.tensor([[0.9, 0.2, 0.7], [0.1, 0.8, 0.3]]), torch.tensor([[1, 0, 0], [0, 1, 1]]))
        >>> metric.compute().tolist()  # tp, fp, tn, fn, support
        [2, 1, 2, 1, 3]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False
    _multilabel = True

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_validate_args(num_labels, threshold, average, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.zero_division = zero_division
        self._create_state(num_labels, multidim_average)

    def _update(self, state: State, preds: Tensor, target: Tensor) -> State:
        p, t, v = _multilabel_format(self._tensor(preds), self._tensor(target), self.threshold, self.ignore_index)
        return self._update_stats(state, *_multilabel_stat_scores_update(p, t, v, self.multidim_average))

    def _compute(self, state: State) -> Tensor:
        return _stack_stats(self._final_state(state), self.average)


class StatScores(_ClassificationTaskWrapper):
    """Task dispatch: ``StatScores(task="binary" | "multiclass" | "multilabel", ...)``."""

    @classmethod
    def _create_task_metric(cls, task: str, *args: Any, **kwargs: Any) -> Metric:
        kwargs.pop("task", None)
        classes = {"binary": BinaryStatScores, "multiclass": MulticlassStatScores, "multilabel": MultilabelStatScores}
        return _dispatch_task(task, classes, STAT_DROPS, (), kwargs)
