"""InfoLM class (counterpart of ``torchmetrics_tpu/text/infolm.py``).

The state is a cat list of the float32 sentence scores on the metric's
device, each update scored by :func:`~torchmetrics_tpu_torch.functional.text.infolm.infolm`
there.

Example::

    >>> from torchmetrics_tpu_torch.text import InfoLM
    >>> metric = InfoLM(information_measure='l2_distance', idf=False, verbose=False, device="cpu")
    >>> metric.update(['the cat sat on the mat'], ['the cat sat on the mat'])
    >>> round(float(metric.compute()), 4)  # identical pair -> zero distance
    0.0
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.text.infolm import _InformationMeasure, infolm
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class InfoLM(Metric):
    """InfoLM; the sentence scores are the state."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        model_name_or_path: str = "bert-base-uncased",
        temperature: float = 0.25,
        information_measure: str = "kl_divergence",
        idf: bool = True,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        max_length: Optional[int] = None,
        batch_size: int = 64,
        num_threads: int = 0,
        verbose: bool = True,
        return_sentence_level_score: bool = False,
        model: Optional[Callable] = None,
        user_tokenizer: Optional[Any] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _InformationMeasure(information_measure, alpha, beta)  # the measure and its parameters, checked now
        self.model_name_or_path = model_name_or_path
        self.temperature = temperature
        self.information_measure = information_measure
        self.idf = idf
        self.alpha = alpha
        self.beta = beta
        self.max_length = max_length
        self.return_sentence_level_score = return_sentence_level_score
        self.model = model
        self.user_tokenizer = user_tokenizer
        self.add_state("scores", [], dist_reduce_fx="cat")

    def _update(self, state: State, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> State:
        _, per_sentence = infolm(
            preds, target,
            model_name_or_path=self.model_name_or_path,
            temperature=self.temperature,
            information_measure=self.information_measure,
            idf=self.idf,
            alpha=self.alpha,
            beta=self.beta,
            device=self.device,
            max_length=self.max_length,
            return_sentence_level_score=True,
            model=self.model,
            user_tokenizer=self.user_tokenizer,
        )
        return {"scores": state["scores"] + (per_sentence.to(torch.float32),)}

    def _compute(self, state: State) -> Union[Tensor, Tuple[Tensor, Tensor]]:
        if not state["scores"]:
            return torch.zeros((), device=self.device)
        scores = dim_zero_cat(state["scores"])
        if self.return_sentence_level_score:
            return scores.mean(), scores
        return scores.mean()
