"""``PanopticQuality`` and ``ModifiedPanopticQuality`` (counterpart of
``torchmetrics_tpu/detection/panoptic_qualities.py``).

Four sum-reduced float32 states of one entry a category (``iou_sum``,
``true_positives``, ``false_positives``, ``false_negatives``), as the JAX
package keeps them; each update runs the functional's per-image matching on
the metric's device (``confmat_multiclass`` on the card).

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.detection import PanopticQuality
    >>> metric = PanopticQuality(things={0, 1}, stuffs={6, 7}, device="cpu")
    >>> preds = torch.tensor([[[[6, 0], [0, 0]], [[6, 0], [7, 0]]]])
    >>> target = torch.tensor([[[[6, 0], [0, 1]], [[6, 0], [7, 0]]]])
    >>> metric.update(preds, target)
    >>> round(float(metric.compute()), 4)
    1.0
"""

from __future__ import annotations

from typing import Any, Collection

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.detection.panoptic_quality import (
    _check_inputs,
    _get_void_color,
    _panoptic_quality_compute,
    _panoptic_quality_update,
    _parse_categories,
    _pq_result,
    _preprocess_inputs,
)


class PanopticQuality(Metric):
    """PQ with sum-reduced per-category (iou_sum, tp, fp, fn) states."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    _modified = False

    def __init__(
        self,
        things: Collection[int],
        stuffs: Collection[int],
        allow_unknown_preds_category: bool = False,
        return_sq_and_rq: bool = False,
        return_per_class: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        things_s, stuffs_s = _parse_categories(things, stuffs)
        self.things = things_s
        self.stuffs = stuffs_s
        self.void_color = _get_void_color(things_s, stuffs_s)
        cats = [*sorted(things_s), *sorted(stuffs_s)]
        self.cat_id_to_continuous_id = {c: i for i, c in enumerate(cats)}
        self.allow_unknown_preds_category = allow_unknown_preds_category
        self.return_sq_and_rq = return_sq_and_rq
        self.return_per_class = return_per_class
        for name in ("iou_sum", "true_positives", "false_positives", "false_negatives"):
            self.add_state(name, torch.zeros(len(cats), dtype=torch.float32), dist_reduce_fx="sum")

    def _update(self, state: State, preds: Any, target: Any) -> State:
        preds, target = torch.as_tensor(preds, device=self.device), torch.as_tensor(target, device=self.device)
        _check_inputs(preds, target)
        flat_preds = _preprocess_inputs(self.things, self.stuffs, preds, self.void_color,
                                        self.allow_unknown_preds_category)
        flat_target = _preprocess_inputs(self.things, self.stuffs, target, self.void_color, True)
        iou_sum, tp, fp, fn = _panoptic_quality_update(
            flat_preds, flat_target, self.cat_id_to_continuous_id, self.void_color,
            modified_metric_stuffs=self.stuffs if self._modified else None,
        )
        return {
            "iou_sum": state["iou_sum"] + iou_sum.to(torch.float32),
            "true_positives": state["true_positives"] + tp.to(torch.float32),
            "false_positives": state["false_positives"] + fp.to(torch.float32),
            "false_negatives": state["false_negatives"] + fn.to(torch.float32),
        }

    def _compute(self, state: State) -> Tensor:
        values = _panoptic_quality_compute(state["iou_sum"], state["true_positives"], state["false_positives"],
                                           state["false_negatives"])
        return _pq_result(values, self.return_sq_and_rq, self.return_per_class)


class ModifiedPanopticQuality(PanopticQuality):
    """PQ-dagger: the stuff categories without the 0.5 matching."""

    _modified = True

    def __init__(
        self,
        things: Collection[int],
        stuffs: Collection[int],
        allow_unknown_preds_category: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(things=things, stuffs=stuffs, allow_unknown_preds_category=allow_unknown_preds_category,
                         **kwargs)
