"""ROUGE modular metric (counterpart of ``torchmetrics_tpu/text/rouge.py``).

Per-sample precision/recall/fmeasure are ``cat`` list states, one float32
vector per update and rouge key, so a sync moves only tensors (a ragged
gather: :func:`torchmetrics_tpu_torch.parallel.sync_ragged_states`).

``approx="reservoir"`` replaces them with a deterministic bottom-k-by-hash
corpus sample (:class:`~torchmetrics_tpu_torch.sketches.ReservoirSketch`): a
fixed ``(sample_size, 1 + 3 len(rouge_keys))`` reservoir keyed by a content
hash of each prediction (:func:`content_key`), synced by one fixed-shape
gather, and an exact ``sum`` counter of samples seen. The estimate is the
mean over kept rows; every per-sample value lies in [0, 1], so the corpus
mean is within ``(n - k) / n * max(m, 1 - m)`` of it (0 while the corpus
fits the reservoir), the bound :meth:`ROUGEScore._gather_approx_provenance`
reports after a compute.

Example::

    >>> from torchmetrics_tpu_torch.text import ROUGEScore
    >>> metric = ROUGEScore(rouge_keys='rouge1', device="cpu")
    >>> metric.update("the cat is on the mat", "a cat is on the mat")
    >>> round(float(metric.compute()['rouge1_fmeasure']), 4)
    0.8333
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.functional.text.rouge import (
    ALLOWED_ACCUMULATE_VALUES,
    ALLOWED_ROUGE_KEYS,
    _rouge_score_update,
)
from torchmetrics_tpu_torch.sketches.reservoir import ReservoirSketch
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

_STATS = ("fmeasure", "precision", "recall")


def content_key(text: str, salt: int = 0) -> int:
    """Deterministic integer key of a sample's content, the reservoir priority's seed (the same sample has the
    same priority on every rank)."""
    return (zlib.crc32(text.encode("utf-8")) ^ (salt * 0x9E3779B1)) & 0xFFFFFFFF


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
        sample_size: int = 1024,
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
        if not (isinstance(sample_size, int) and sample_size >= 1):
            raise ValueError(f"Argument `sample_size` must be a positive int, got {sample_size!r}")
        #: reservoir capacity under ``approx="reservoir"`` (rows kept)
        self.sample_size = sample_size
        self._install_approx_states()

    def _install_approx_states(self) -> None:
        """Register the state leaves of the current ``approx`` config (the :meth:`set_approx` hook)."""
        if self.approx == "reservoir":
            self._reservoir = ReservoirSketch(capacity=self.sample_size, fields=len(self.rouge_keys) * len(_STATS))
            self.add_state("corpus_sample", self._reservoir.init(), dist_reduce_fx=self._reservoir.reduce_spec)
            self.add_state("samples_total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
            return
        self._reservoir = None
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
        if self._reservoir is not None:
            records = np.zeros((len(preds), self._reservoir.fields), np.float32)
            for key_val, samples in results.items():
                col0 = self.rouge_keys.index(inv[key_val]) * len(_STATS)
                for j, stat in enumerate(_STATS):
                    records[:, col0 + j] = [s[stat] for s in samples]
            keys = torch.tensor([content_key(p) for p in preds], dtype=torch.int64, device=self.device)
            return {
                "corpus_sample": self._reservoir.insert_batch(state["corpus_sample"], torch.from_numpy(records), keys),
                "samples_total": state["samples_total"] + len(preds),
            }
        new = dict(state)
        for key_val, samples in results.items():
            name = inv[key_val]
            for stat in _STATS:
                vals = torch.tensor([s[stat] for s in samples], dtype=torch.float32, device=self.device)
                new[f"{name}_{stat}"] = new[f"{name}_{stat}"] + (vals,)
        return new

    def _compute(self, state: State) -> Dict[str, Tensor]:
        out: Dict[str, Tensor] = {}
        if self._reservoir is not None:  # on the host, in numpy, as the JAX package estimates
            sample = state["corpus_sample"].cpu()
            mask = self._reservoir.valid_mask(sample).numpy()
            payload = self._reservoir.payload(sample).numpy()
            kept, total = int(mask.sum()), int(state["samples_total"])
            worst = 0.0
            for i, key in enumerate(self.rouge_keys):
                for j, stat in enumerate(_STATS):
                    col = payload[mask, i * len(_STATS) + j]
                    mean = float(col.mean()) if kept else 0.0
                    out[f"{key}_{stat}"] = torch.tensor(mean, dtype=torch.float32, device=self.device)
                    if total > kept:
                        worst = max(worst, (total - kept) / total * max(mean, 1.0 - mean))
            # the unsampled mass can pull a [0, 1] mean by at most its fraction times the worst deviation
            self.__dict__["_reservoir_bound"] = worst
            return out
        for key in self.rouge_keys:
            for stat in _STATS:
                vals = state[f"{key}_{stat}"]
                out[f"{key}_{stat}"] = dim_zero_cat(vals).mean() if vals else torch.zeros((), device=self.device)
        return out

    def _gather_approx_provenance(self) -> Optional[Dict[str, Any]]:
        """The reservoir's provenance row, with the sampling bound of the last ``compute`` (0 before one)."""
        if self._reservoir is None:
            return None
        return {
            "source": "gather_approx",
            "kind": "reservoir",
            "capacity": self._reservoir.capacity,
            "fields": self._reservoir.fields,
            "bound": float(self.__dict__.get("_reservoir_bound", 0.0)),
        }
