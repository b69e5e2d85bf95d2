"""BLEU score (counterpart of ``torchmetrics_tpu/functional/text/bleu.py``).

N-gram counting is host Python (strings never reach the device), copied from
the JAX package; the metric state is four float32 tensors: the clipped-match
numerator and the denominator of each n-gram order, and the candidate and
reference length sums, so a sync is a plain sum.

Example::

    >>> from torchmetrics_tpu_torch.functional.text.bleu import bleu_score
    >>> preds = ['the cat is on the mat']
    >>> target = [['there is a cat on the mat', 'a cat is on the mat']]
    >>> round(float(bleu_score(preds, target)), 4)
    0.7598
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.helper import _count_ngram


def _tokenize_fn(line: str) -> Sequence[str]:
    return line.split()


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    numerator: np.ndarray,
    denominator: np.ndarray,
    preds_len: float,
    target_len: float,
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[float, float]:
    """Accumulate clipped n-gram matches into ``numerator`` and ``denominator`` (host arrays, in place)."""
    target_tok = [[tokenizer(line) if line else [] for line in t] for t in target]
    preds_tok = [tokenizer(line) if line else [] for line in preds]

    for pred, targets in zip(preds_tok, target_tok):
        preds_len += len(pred)
        target_lens = [len(t) for t in targets]
        diffs = [abs(len(pred) - x) for x in target_lens]
        target_len += target_lens[diffs.index(min(diffs))]

        preds_counter = _count_ngram(pred, n_gram)
        target_counter: Counter = Counter()
        for tgt in targets:
            target_counter |= _count_ngram(tgt, n_gram)
        clipped = preds_counter & target_counter
        for ng in clipped:
            numerator[len(ng) - 1] += clipped[ng]
        for ng in preds_counter:
            denominator[len(ng) - 1] += preds_counter[ng]
    return preds_len, target_len


def _bleu_score_compute(
    preds_len: Tensor,
    target_len: Tensor,
    numerator: Tensor,
    denominator: Tensor,
    n_gram: int,
    weights: Sequence[float],
    smooth: bool,
) -> Tensor:
    """Geometric mean of the modified precisions times the brevity penalty, in float32."""
    numerator = torch.as_tensor(numerator, dtype=torch.float32)
    denominator = torch.as_tensor(denominator, dtype=torch.float32, device=numerator.device)
    preds_len = torch.as_tensor(preds_len, dtype=torch.float32, device=numerator.device)
    target_len = torch.as_tensor(target_len, dtype=torch.float32, device=numerator.device)
    if float(numerator.min()) == 0.0:
        return torch.tensor(0.0, device=numerator.device)
    if smooth:
        precision = (numerator + 1.0) / (denominator + 1.0)
        precision[0] = numerator[0] / denominator[0]
    else:
        precision = numerator / denominator
    log_precision = torch.tensor(list(weights), dtype=torch.float32, device=numerator.device) * torch.log(precision)
    geometric_mean = torch.exp(log_precision.sum())
    brevity = torch.where(preds_len > target_len, 1.0, torch.exp(1.0 - target_len / preds_len))
    return brevity * geometric_mean


def _check_corpus(preds, target, n_gram: int, weights: Optional[Sequence[float]]):
    """The corpus as lists (a reference string becomes a list of one) and the weights (uniform by default)."""
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    return preds_, target_, weights if weights is not None else [1.0 / n_gram] * n_gram


def _corpus_bleu(preds, target, n_gram, smooth, weights, tokenizer) -> Tensor:
    preds_, target_, weights = _check_corpus(preds, target, n_gram, weights)
    numerator = np.zeros(n_gram)
    denominator = np.zeros(n_gram)
    preds_len, target_len = _bleu_score_update(preds_, target_, numerator, denominator, 0.0, 0.0, n_gram, tokenizer)
    return _bleu_score_compute(torch.tensor(preds_len), torch.tensor(target_len), torch.from_numpy(numerator),
                               torch.from_numpy(denominator), n_gram, weights, smooth)


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    weights: Optional[Sequence[float]] = None,
) -> Tensor:
    """Corpus BLEU with one or more references per sample."""
    return _corpus_bleu(preds, target, n_gram, smooth, weights, _tokenize_fn)
