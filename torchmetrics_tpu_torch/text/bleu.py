"""BLEU and SacreBLEU classes (counterpart of ``torchmetrics_tpu/text/bleu.py``).

The state is four float32 tensors on the metric's device: the clipped-match
numerator and the denominator of each n-gram order, and the prediction and
reference length sums; a sync is a plain sum.

``approx="reservoir"`` keeps the per-sentence stat rows instead, bounded at
``sample_size`` by a deterministic bottom-k-by-hash corpus sample
(:class:`~torchmetrics_tpu_torch.sketches.ReservoirSketch`, one row a
sentence: ``[preds_len, target_len, numerator(n), denominator(n)]``, keyed by
:func:`~torchmetrics_tpu_torch.text.rouge.content_key` of the prediction),
and estimates the corpus sums by reweighting the kept rows by
``total_seen / kept``; the reported bound is the unsampled fraction
``(n - k) / n`` (0 while the corpus fits the reservoir). ``SacreBLEUScore``
inherits the mode.

Example::

    >>> from torchmetrics_tpu_torch.text import BLEUScore
    >>> metric = BLEUScore(n_gram=2, device="cpu")
    >>> metric.update(["the cat is on the mat"], [["a cat is on the mat"]])
    >>> round(float(metric.compute()), 4)
    0.8165
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update, _tokenize_fn
from torchmetrics_tpu_torch.functional.text.sacre_bleu import AVAILABLE_TOKENIZERS, _SacreBLEUTokenizer
from torchmetrics_tpu_torch.sketches.reservoir import ReservoirSketch


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
        sample_size: int = 1024,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        if weights is not None and len(weights) != n_gram:
            raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
        self.weights = weights if weights is not None else [1.0 / n_gram] * n_gram
        self._tokenizer = _tokenize_fn
        if not (isinstance(sample_size, int) and sample_size >= 1):
            raise ValueError(f"Argument `sample_size` must be a positive int, got {sample_size!r}")
        #: reservoir capacity under ``approx="reservoir"`` (sentence rows kept)
        self.sample_size = sample_size
        self._install_approx_states()

    def _install_approx_states(self) -> None:
        """Register the state leaves of the current ``approx`` config (the :meth:`set_approx` hook)."""
        if self.approx == "reservoir":
            self._reservoir = ReservoirSketch(capacity=self.sample_size, fields=2 + 2 * self.n_gram)
            self.add_state("corpus_sample", self._reservoir.init(), dist_reduce_fx=self._reservoir.reduce_spec)
            self.add_state("samples_total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
            return
        self._reservoir = None
        self.add_state("preds_len", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("target_len", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("numerator", torch.zeros(self.n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", torch.zeros(self.n_gram), dist_reduce_fx="sum")

    def _update(self, state: State, preds: Union[str, Sequence[str]], target: Sequence) -> State:
        preds_ = [preds] if isinstance(preds, str) else list(preds)
        target_ = [[t] if isinstance(t, str) else list(t) for t in target]
        if len(preds_) != len(target_):
            raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
        if self._reservoir is not None:
            return self._update_reservoir(state, preds_, target_)
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

    def _update_reservoir(self, state: State, preds_: list, target_: list) -> State:
        """One stat row a sentence, counted on the host as the JAX package counts it, into the reservoir."""
        from torchmetrics_tpu_torch.text.rouge import content_key

        n = len(preds_)
        records = np.zeros((n, self._reservoir.fields), np.float32)
        for i, (p, t) in enumerate(zip(preds_, target_)):
            num = np.zeros(self.n_gram)
            den = np.zeros(self.n_gram)
            p_len, t_len = _bleu_score_update([p], [t], num, den, 0.0, 0.0, self.n_gram, self._tokenizer)
            records[i] = np.concatenate([[p_len, t_len], num, den])
        keys = torch.tensor([content_key(p) for p in preds_], dtype=torch.int64, device=self.device)
        return {
            "corpus_sample": self._reservoir.insert_batch(state["corpus_sample"], torch.from_numpy(records), keys),
            "samples_total": state["samples_total"] + n,
        }

    def _compute(self, state: State) -> Tensor:
        if self._reservoir is not None:  # on the host, in float64, as the JAX package estimates
            sample = state["corpus_sample"].cpu()
            mask = self._reservoir.valid_mask(sample).numpy()
            payload = self._reservoir.payload(sample).numpy().astype(np.float64)
            kept, total = int(mask.sum()), int(state["samples_total"])
            # every corpus sum scales by total / kept: the kept rows are a uniform sample over the keys
            scale = (total / kept) if kept else 0.0
            self.__dict__["_reservoir_bound"] = ((total - kept) / total) if total > kept else 0.0
            sums = payload[mask].sum(axis=0) * scale
            g = self.n_gram
            as32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)  # noqa: E731
            return _bleu_score_compute(as32(sums[0]), as32(sums[1]), as32(sums[2 : 2 + g]),
                                       as32(sums[2 + g : 2 + 2 * g]), self.n_gram, self.weights, self.smooth)
        return _bleu_score_compute(state["preds_len"], state["target_len"], state["numerator"],
                                   state["denominator"], self.n_gram, self.weights, self.smooth)

    def _gather_approx_provenance(self) -> Optional[Dict[str, Any]]:
        """The reservoir's provenance row, with the unsampled fraction of the last ``compute`` (0 before one)."""
        if self._reservoir is None:
            return None
        return {
            "source": "gather_approx",
            "kind": "reservoir",
            "capacity": self._reservoir.capacity,
            "fields": self._reservoir.fields,
            "bound": float(self.__dict__.get("_reservoir_bound", 0.0)),
        }


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
