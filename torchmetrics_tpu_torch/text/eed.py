"""Extended Edit Distance class (counterpart of ``torchmetrics_tpu/text/eed.py``).

The state is a cat list of the float32 sentence scores on the metric's
device; the corpus score is their mean.

Example::

    >>> from torchmetrics_tpu_torch.text import ExtendedEditDistance
    >>> metric = ExtendedEditDistance(device="cpu")
    >>> metric.update(['this is the prediction'], ['this is the reference'])
    >>> round(float(metric.compute()), 4)
    0.3835
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.text.eed import _eed_update
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class ExtendedEditDistance(Metric):
    """Corpus EED, the mean of the sentence scores."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        language: str = "en",
        return_sentence_level_score: bool = False,
        alpha: float = 2.0,
        rho: float = 0.3,
        deletion: float = 0.2,
        insertion: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        for name, val in (("alpha", alpha), ("rho", rho), ("deletion", deletion), ("insertion", insertion)):
            if not isinstance(val, float) or val < 0:
                raise ValueError(f"Parameter `{name}` is expected to be a non-negative float.")
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion
        self.add_state("sentence_eed", [], dist_reduce_fx="cat")

    def _update(
        self, state: State, preds: Union[str, Sequence[str]], target: Sequence[Union[str, Sequence[str]]]
    ) -> State:
        scores: List[float] = []
        _eed_update(preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion, scores)
        return {"sentence_eed": state["sentence_eed"] + (torch.tensor(scores, dtype=torch.float32, device=self.device),)}

    def _compute(self, state: State) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        if not state["sentence_eed"]:
            return torch.zeros((), device=self.device)
        scores = dim_zero_cat(state["sentence_eed"])
        avg = scores.mean()
        if self.return_sentence_level_score:
            return avg, scores
        return avg
