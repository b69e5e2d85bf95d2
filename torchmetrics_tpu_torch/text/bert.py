"""BERTScore class (counterpart of ``torchmetrics_tpu/text/bert.py``).

The state is the tokenized ids and attention masks of both sides, four cat
lists of int32 tensors on the metric's device: strings never enter a sync.
The compute embeds them with the model (``model=`` and ``user_tokenizer=``, or
a local checkpoint directory; nothing is downloaded) and scores them with one
``bert_greedy_match`` launch on the card.

Example::

    >>> from torchmetrics_tpu_torch.text import BERTScore
    >>> metric = BERTScore(verbose=False, device="cpu")
    >>> metric.update(['the cat sat'], ['the cat sat'])
    >>> {k: round(float(v[0]), 4) for k, v in sorted(metric.compute().items())}
    {'f1': 1.0, 'precision': 1.0, 'recall': 1.0}
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.text.bert import _reject_unsupported_bert_args, _score_ids, resolve_embedder

_LEAVES = ("preds_input_ids", "preds_attention_mask", "target_input_ids", "target_attention_mask")


class BERTScore(Metric):
    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        num_layers: Optional[int] = None,
        all_layers: bool = False,
        model: Optional[Callable] = None,
        user_tokenizer: Optional[Any] = None,
        user_forward_fn: Optional[Callable] = None,
        verbose: bool = False,
        idf: bool = False,
        max_length: int = 512,
        batch_size: int = 64,
        num_threads: int = 0,
        return_hash: bool = False,
        lang: str = "en",
        rescale_with_baseline: bool = False,
        baseline_path: Optional[str] = None,
        baseline_url: Optional[str] = None,
        truncation: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _reject_unsupported_bert_args(all_layers, rescale_with_baseline)
        self.idf = idf
        self.return_hash = return_hash
        self.embed_fn, self.tokenizer, self._zero_special, self.model_name_or_path = resolve_embedder(
            model_name_or_path, num_layers, max_length, truncation=truncation,
            model=model, user_tokenizer=user_tokenizer, user_forward_fn=user_forward_fn,
        )
        for name in _LEAVES:
            self.add_state(name, [], dist_reduce_fx="cat")

    def _update(self, state: State, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> State:
        preds_l = [preds] if isinstance(preds, str) else list(preds)
        target_l = [target] if isinstance(target, str) else list(target)
        if len(preds_l) != len(target_l):
            raise ValueError("Number of predicted and reference sententes must be the same!")
        p = self.tokenizer(preds_l)
        t = self.tokenizer(target_l)
        new = [p["input_ids"], p["attention_mask"], t["input_ids"], t["attention_mask"]]
        return {name: state[name] + (self._tensor(np.asarray(x)),) for name, x in zip(_LEAVES, new)}

    @staticmethod
    def _pad_cat(chunks: Sequence[Tensor]) -> np.ndarray:
        t_max = max(c.shape[1] for c in chunks)
        return np.concatenate([np.pad(c.cpu().numpy(), ((0, 0), (0, t_max - c.shape[1]))) for c in chunks], axis=0)

    def _compute(self, state: State) -> Dict[str, Tensor]:
        if not state["preds_input_ids"]:
            empty = torch.zeros(0, device=self.device)
            return {"precision": empty, "recall": empty.clone(), "f1": empty.clone()}
        p_ids, p_mask, t_ids, t_mask = (self._pad_cat(state[name]) for name in _LEAVES)
        precision, recall, f1 = _score_ids(self.embed_fn, self._zero_special, self.idf, p_ids, p_mask, t_ids, t_mask,
                                           self.device)
        out: Dict[str, Any] = {"precision": precision, "recall": recall, "f1": f1}
        if self.return_hash:
            out["hash"] = f"tpu_bert_score(model={self.model_name_or_path or 'user-model'})"
        return out
