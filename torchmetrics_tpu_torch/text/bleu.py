"""BLEU and SacreBLEU classes (counterpart of ``torchmetrics_tpu/text/bleu.py``), the exact path.

The state is four float32 tensors on the metric's device: the clipped-match
numerator and the denominator of each n-gram order, and the prediction and
reference length sums; a sync is a plain sum. The JAX package's
``approx="reservoir"`` layout is not ported: the base class refuses ``approx``.

Example::

    >>> from torchmetrics_tpu_torch.text import BLEUScore
    >>> metric = BLEUScore(n_gram=2, device="cpu")
    >>> metric.update(["the cat is on the mat"], [["a cat is on the mat"]])
    >>> round(float(metric.compute()), 4)
    0.8165
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _tokenize_fn
from torchmetrics_tpu_torch.functional.text.sacre_bleu import AVAILABLE_TOKENIZERS, _SacreBLEUTokenizer


class BLEUScore(Metric):
    """Corpus BLEU; the states are the per-order numerator and denominator and the length sums."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        if weights is not None and len(weights) != n_gram:
            raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
        self.weights = weights if weights is not None else [1.0 / n_gram] * n_gram
        self._tokenizer = _tokenize_fn
        self.add_state("preds_len", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("target_len", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("numerator", torch.zeros(n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", torch.zeros(n_gram), dist_reduce_fx="sum")

    def _update(self, state: State, preds: Union[str, Sequence[str]], target: Sequence) -> State:
        preds_ = [preds] if isinstance(preds, str) else list(preds)
        target_ = [[t] if isinstance(t, str) else list(t) for t in target]
        if len(preds_) != len(target_):
            raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
        # the counts of this batch alone, added into the state as float32 (the JAX package counts from the state
        # in float64 and rounds the new totals: the same for counts below 2**24)
        numerator = np.zeros(self.n_gram)
        denominator = np.zeros(self.n_gram)
        preds_len, target_len = _bleu_score_update(preds_, target_, numerator, denominator, 0.0, 0.0, self.n_gram,
                                                   self._tokenizer)
        new = [torch.as_tensor(x, dtype=torch.float32, device=self.device)
               for x in (preds_len, target_len, numerator, denominator)]
        return {
            "preds_len": state["preds_len"] + new[0],
            "target_len": state["target_len"] + new[1],
            "numerator": state["numerator"] + new[2],
            "denominator": state["denominator"] + new[3],
        }

    def _compute(self, state: State) -> Tensor:
        return _bleu_score_compute(state["preds_len"], state["target_len"], state["numerator"],
                                   state["denominator"], self.n_gram, self.weights, self.smooth)


class SacreBLEUScore(BLEUScore):
    """BLEU with canonical tokenization.

    Example::

        >>> from torchmetrics_tpu_torch.text import SacreBLEUScore
        >>> metric = SacreBLEUScore(device="cpu")
        >>> metric.update(["the cat is on the mat"], [["a cat is on the mat"]])
        >>> round(float(metric.compute()), 4)
        0.7598
    """

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        tokenize: str = "13a",
        lowercase: bool = False,
        weights: Optional[Sequence[float]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, weights=weights, **kwargs)
        if tokenize not in AVAILABLE_TOKENIZERS:
            raise ValueError(f"Argument `tokenize` expected to be one of {list(AVAILABLE_TOKENIZERS)}")
        self.tokenize = tokenize
        self.lowercase = lowercase
        self._tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)
