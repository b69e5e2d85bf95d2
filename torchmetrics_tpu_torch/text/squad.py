"""SQuAD class (counterpart of ``torchmetrics_tpu/text/squad.py``).

The state is three float32 sums on the metric's device: F1, exact match and
the question count.

Example::

    >>> from torchmetrics_tpu_torch.text import SQuAD
    >>> metric = SQuAD(device="cpu")
    >>> preds = [{'prediction_text': '1976', 'id': '1'}]
    >>> target = [{'answers': {'answer_start': [97], 'text': ['1976']}, 'id': '1'}]
    >>> metric.update(preds, target)
    >>> {k: float(v) for k, v in sorted(metric.compute().items())}
    {'exact_match': 100.0, 'f1': 100.0}
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.text.squad import (
    PREDS_TYPE,
    TARGETS_TYPE,
    _squad_compute,
    _squad_input_check,
    _squad_update,
)


class SQuAD(Metric):
    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 100.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("exact_match", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def _update(self, state: State, preds: PREDS_TYPE, target: TARGETS_TYPE) -> State:
        preds_dict, articles = _squad_input_check(preds, target)
        f1, em, total = (x.to(self.device) for x in _squad_update(preds_dict, articles))
        return {
            "f1_score": state["f1_score"] + f1,
            "exact_match": state["exact_match"] + em,
            "total": state["total"] + total,
        }

    def _compute(self, state: State) -> Dict[str, Tensor]:
        return _squad_compute(state["f1_score"], state["exact_match"], state["total"])
