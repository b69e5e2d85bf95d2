"""ROUGE modular metric (counterpart of ``torchmetrics_tpu/text/rouge.py``), the exact path.

Per-sample precision/recall/fmeasure are ``cat`` list states, one float32
vector per update and rouge key, so a sync moves only tensors (a ragged
gather: :func:`torchmetrics_tpu_torch.parallel.sync_ragged_states`). The
JAX package's ``approx="reservoir"`` layout is not ported yet.

Example::

    >>> from torchmetrics_tpu_torch.text import ROUGEScore
    >>> metric = ROUGEScore(rouge_keys='rouge1', device="cpu")
    >>> metric.update("the cat is on the mat", "a cat is on the mat")
    >>> round(float(metric.compute()['rouge1_fmeasure']), 4)
    0.8333
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.text.rouge import (
    ALLOWED_ACCUMULATE_VALUES,
    ALLOWED_ROUGE_KEYS,
    _rouge_score_update,
)
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

_STATS = ("fmeasure", "precision", "recall")


class ROUGEScore(Metric):
    """ROUGE-N/L/Lsum over (prediction, reference) text pairs."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        use_stemmer: bool = False,
        normalizer: Optional[Callable[[str], str]] = None,
        tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
        accumulate: str = "best",
        rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if accumulate not in ALLOWED_ACCUMULATE_VALUES:
            raise ValueError(
                f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
            )
        if isinstance(rouge_keys, str):
            rouge_keys = (rouge_keys,)
        for key in rouge_keys:
            if key not in ALLOWED_ROUGE_KEYS:
                raise ValueError(
                    f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS.keys())}"
                )
        self.rouge_keys = rouge_keys
        self.rouge_keys_values = [ALLOWED_ROUGE_KEYS[k] for k in rouge_keys]
        self.normalizer = normalizer
        self.tokenizer = tokenizer
        self.accumulate = accumulate
        self.stemmer = None
        if use_stemmer:
            try:
                from nltk.stem.porter import PorterStemmer  # type: ignore
            except ImportError as err:
                raise ModuleNotFoundError("Stemmer requires the `nltk` package which is not installed.") from err
            self.stemmer = PorterStemmer()
        for key in self.rouge_keys:
            for stat in _STATS:
                self.add_state(f"{key}_{stat}", [], dist_reduce_fx="cat")

    def _update(self, state: State, preds: Union[str, Sequence[str]], target) -> State:
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(target, str):
            target = [[target]]
        elif len(target) > 0 and isinstance(target[0], str):
            target = [[t] for t in target]
        results = _rouge_score_update(
            preds, target, self.rouge_keys_values, self.accumulate, self.stemmer, self.normalizer, self.tokenizer,
        )
        inv = {v: k for k, v in ALLOWED_ROUGE_KEYS.items()}
        new = dict(state)
        for key_val, samples in results.items():
            name = inv[key_val]
            for stat in _STATS:
                vals = torch.tensor([s[stat] for s in samples], dtype=torch.float32, device=self.device)
                new[f"{name}_{stat}"] = new[f"{name}_{stat}"] + (vals,)
        return new

    def _compute(self, state: State) -> Dict[str, Tensor]:
        out: Dict[str, Tensor] = {}
        for key in self.rouge_keys:
            for stat in _STATS:
                vals = state[f"{key}_{stat}"]
                out[f"{key}_{stat}"] = dim_zero_cat(vals).mean() if vals else torch.zeros((), device=self.device)
        return out
