"""ROUGE score (counterpart of ``torchmetrics_tpu/functional/text/rouge.py``).

ROUGE-N via clipped n-gram overlap, ROUGE-L via LCS, ROUGE-Lsum via
summary-level union-LCS. Per-sample precision/recall/fmeasure triples are
the metric state (list/"cat"-reduced). Tokenizing and scoring are host
Python, copied from the JAX package; only the result becomes a tensor.
Sentences for Lsum are split by a regex, as in the JAX package.

Example::

    >>> from torchmetrics_tpu_torch.functional.text.rouge import rouge_score
    >>> preds = 'My name is John'
    >>> target = 'Is your name John'
    >>> {k: round(float(v), 4) for k, v in sorted(rouge_score(preds, target, rouge_keys='rouge1').items())}
    {'rouge1_fmeasure': 0.75, 'rouge1_precision': 0.75, 'rouge1_recall': 0.75}
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.helper import _lcs_length, _lcs_members

ALLOWED_ROUGE_KEYS: Dict[str, Union[int, str]] = {
    "rouge1": 1, "rouge2": 2, "rouge3": 3, "rouge4": 4, "rouge5": 5,
    "rouge6": 6, "rouge7": 7, "rouge8": 8, "rouge9": 9,
    "rougeL": "L", "rougeLsum": "Lsum",
}
ALLOWED_ACCUMULATE_VALUES = ("avg", "best")


def _split_sentence(x: str) -> Sequence[str]:
    """Regex sentence splitter."""
    x = re.sub("<n>", "", x)
    parts = re.split(r"(?<=[.!?])\s+|\n+", x.strip())
    return [p for p in parts if p]


def _normalize_and_tokenize_text(
    text: str,
    stemmer: Optional[object] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Sequence[str]:
    """Rouge-score text normalization."""
    text = normalizer(text) if callable(normalizer) else re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = tokenizer(text) if callable(tokenizer) else re.split(r"\s+", text)
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if isinstance(x, str) and len(x) > 0]


def _compute_metrics(hits_or_lcs: int, pred_len: int, target_len: int) -> Dict[str, float]:
    precision = hits_or_lcs / pred_len if pred_len else 0.0
    recall = hits_or_lcs / target_len if target_len else 0.0
    if precision + recall == 0.0:
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    fmeasure = 2 * precision * recall / (precision + recall)
    return {"precision": precision, "recall": recall, "fmeasure": fmeasure}


def _rouge_n_score(pred: Sequence[str], target: Sequence[str], n_gram: int) -> Dict[str, float]:
    """Clipped n-gram overlap."""

    def ngram_counter(tokens: Sequence[str]) -> Counter:
        return Counter(tuple(tokens[i : i + n_gram]) for i in range(len(tokens) - n_gram + 1))

    pred_ngrams, target_ngrams = ngram_counter(pred), ngram_counter(target)
    pred_len, target_len = sum(pred_ngrams.values()), sum(target_ngrams.values())
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    hits = sum((pred_ngrams & target_ngrams).values())
    return _compute_metrics(hits, pred_len, target_len)


def _rouge_l_score(pred: Sequence[str], target: Sequence[str]) -> Dict[str, float]:
    """LCS-based score."""
    if 0 in (len(pred), len(target)):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    lcs = _lcs_length(pred, target)
    return _compute_metrics(lcs, len(pred), len(target))


def _rouge_lsum_score(
    pred_sents: Sequence[Sequence[str]], target_sents: Sequence[Sequence[str]]
) -> Dict[str, float]:
    """Summary-level union-LCS."""
    pred_len = sum(map(len, pred_sents))
    target_len = sum(map(len, target_sents))
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}

    def token_counts(sents: Sequence[Sequence[str]]) -> Counter:
        c: Counter = Counter()
        for s in sents:
            c.update(s)
        return c

    pred_counter = token_counts(pred_sents)
    target_counter = token_counts(target_sents)

    hits = 0
    for tgt in target_sents:
        # union of LCS member tokens of tgt against every pred sentence
        union_idx: set = set()
        for p in pred_sents:
            union_idx |= _lcs_members(p, tgt)
        lcs_tokens = Counter(tgt[i] for i in union_idx)
        # clip by both counters (rouge_score union-LCS clipping)
        for tok, cnt in lcs_tokens.items():
            hits += min(cnt, pred_counter[tok], target_counter[tok])
    return _compute_metrics(hits, pred_len, target_len)


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: List[Union[int, str]],
    accumulate: str = "best",
    stemmer: Optional[object] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Dict[Union[int, str], List[Dict[str, float]]]:
    """Per-sample scores vs multiple references."""
    results: Dict[Union[int, str], List[Dict[str, float]]] = {k: [] for k in rouge_keys_values}
    for pred_raw, target_raw in zip(preds, target):
        pred = _normalize_and_tokenize_text(pred_raw, stemmer, normalizer, tokenizer)
        if "Lsum" in rouge_keys_values:
            pred_lsum = [
                _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer)
                for s in _split_sentence(pred_raw)
            ]
        per_ref: List[Dict[Union[int, str], Dict[str, float]]] = []
        for tgt_raw in target_raw:
            tgt = _normalize_and_tokenize_text(tgt_raw, stemmer, normalizer, tokenizer)
            scores: Dict[Union[int, str], Dict[str, float]] = {}
            for key in rouge_keys_values:
                if isinstance(key, int):
                    scores[key] = _rouge_n_score(pred, tgt, key)
                elif key == "L":
                    scores[key] = _rouge_l_score(pred, tgt)
                elif key == "Lsum":
                    tgt_lsum = [
                        _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer)
                        for s in _split_sentence(tgt_raw)
                    ]
                    scores[key] = _rouge_lsum_score(pred_lsum, tgt_lsum)
            per_ref.append(scores)

        if accumulate == "best":
            key0 = rouge_keys_values[0]
            best_idx = int(np.argmax([s[key0]["fmeasure"] for s in per_ref]))
            for key in rouge_keys_values:
                results[key].append(per_ref[best_idx][key])
        else:  # avg
            for key in rouge_keys_values:
                avg = {
                    stat: float(np.mean([s[key][stat] for s in per_ref]))
                    for stat in ("precision", "recall", "fmeasure")
                }
                results[key].append(avg)
    return results


def _rouge_score_compute(sentence_results: Dict[str, List[float]]) -> Dict[str, Tensor]:
    return {k: torch.tensor(np.mean(v) if len(v) else 0.0, dtype=torch.float32) for k, v in sentence_results.items()}


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
) -> Dict[str, Tensor]:
    """ROUGE score dict {key_precision|recall|fmeasure}."""
    if use_stemmer:
        try:
            from nltk.stem.porter import PorterStemmer  # type: ignore
        except ImportError as err:
            raise ModuleNotFoundError(
                "Stemmer requires the `nltk` package which is not installed."
            ) from err
        stemmer = PorterStemmer()
    else:
        stemmer = None

    if accumulate not in ALLOWED_ACCUMULATE_VALUES:
        raise ValueError(
            f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
        )
    if isinstance(rouge_keys, str):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS.keys())}")
    rouge_keys_values = [ALLOWED_ROUGE_KEYS[k] for k in rouge_keys]

    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [[target]]
    elif len(target) > 0 and isinstance(target[0], str):
        target = [[t] for t in target]

    results = _rouge_score_update(
        preds, target, rouge_keys_values, accumulate, stemmer, normalizer, tokenizer
    )
    out: Dict[str, List[float]] = {}
    for key, vals in results.items():
        name = {v: k for k, v in ALLOWED_ROUGE_KEYS.items()}[key]
        for stat in ("precision", "recall", "fmeasure"):
            out[f"{name}_{stat}"] = [v[stat] for v in vals]
    return _rouge_score_compute(out)
