"""chrF / chrF++ score (counterpart of ``torchmetrics_tpu/functional/text/chrf.py``).

The n-gram statistics are host Python and numpy, copied from the JAX
package: six count arrays (matching, hypothesis and reference counts of each
character and word n-gram order), which the class keeps as float32 sums.

Example::

    >>> from torchmetrics_tpu_torch.functional.text.chrf import chrf_score
    >>> preds = ['the cat is on the mat']
    >>> target = [['there is a cat on the mat']]
    >>> round(float(chrf_score(preds, target)), 4)
    0.4942
"""

from __future__ import annotations

import string
from collections import Counter
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

_PUNCTUATIONS = set(string.punctuation)
_EPS_SMOOTHING = 1e-16


def _get_characters(sentence: str, whitespace: bool) -> List[str]:
    if whitespace:
        return list(sentence)
    return list(sentence.strip().replace(" ", ""))


def _separate_word_and_punctuation(word: str) -> List[str]:
    if len(word) == 1:
        return [word]
    if word[-1] in _PUNCTUATIONS:
        return [word[:-1], word[-1]]
    if word[0] in _PUNCTUATIONS:
        return [word[0], word[1:]]
    return [word]


def _get_words_and_punctuation(sentence: str) -> List[str]:
    out: List[str] = []
    for word in sentence.strip().split():
        out.extend(_separate_word_and_punctuation(word))
    return out


def _ngram_counts(tokens: List[str], n_order: int) -> List[Counter]:
    """Counters for each order 1..n_order."""
    return [
        Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))
        for n in range(1, n_order + 1)
    ]


def _totals(counters: List[Counter]) -> np.ndarray:
    return np.asarray([sum(c.values()) for c in counters], dtype=np.float64)


def _matches(a: List[Counter], b: List[Counter]) -> np.ndarray:
    return np.asarray([sum((ca & cb).values()) for ca, cb in zip(a, b)], dtype=np.float64)


def _fscore(
    match_char: np.ndarray, match_word: np.ndarray,
    hyp_char: np.ndarray, hyp_word: np.ndarray,
    ref_char: np.ndarray, ref_word: np.ndarray,
    n_order: float, beta: float,
) -> float:
    """Average of the per-order F_beta scores."""

    def per_order(match, hyp, ref):
        p = np.where(hyp > 0, match / np.maximum(hyp, 1), 0.0)
        r = np.where(ref > 0, match / np.maximum(ref, 1), 0.0)
        denom = np.maximum(beta**2 * p + r, _EPS_SMOOTHING)
        return (1 + beta**2) * p * r / denom

    total = per_order(match_char, hyp_char, ref_char).sum()
    if len(match_word):
        total += per_order(match_word, hyp_word, ref_word).sum()
    return float(total / n_order)


class _ChrFStats:
    """Mutable host-side accumulator mirroring the class states."""

    def __init__(self, n_char_order: int, n_word_order: int) -> None:
        self.matching_char = np.zeros(n_char_order)
        self.matching_word = np.zeros(n_word_order)
        self.preds_char = np.zeros(n_char_order)
        self.preds_word = np.zeros(n_word_order)
        self.target_char = np.zeros(n_char_order)
        self.target_word = np.zeros(n_word_order)


def _chrf_score_update(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    stats: _ChrFStats,
    n_char_order: int,
    n_word_order: int,
    beta: float,
    lowercase: bool,
    whitespace: bool,
    sentence_scores: Optional[List[float]] = None,
) -> None:
    """Accumulate the statistics of each sentence's best-matching reference."""
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    n_order = float(n_char_order + n_word_order)

    for pred, refs in zip(preds_, target_):
        p = pred.lower() if lowercase else pred
        p_char = _ngram_counts(_get_characters(p, whitespace), n_char_order)
        p_word = _ngram_counts(_get_words_and_punctuation(p), n_word_order)
        hyp_char, hyp_word = _totals(p_char), _totals(p_word)

        best = (-1.0, None)
        for ref in refs:
            r = ref.lower() if lowercase else ref
            r_char = _ngram_counts(_get_characters(r, whitespace), n_char_order)
            r_word = _ngram_counts(_get_words_and_punctuation(r), n_word_order)
            ref_char, ref_word = _totals(r_char), _totals(r_word)
            m_char = _matches(r_char, p_char)
            m_word = _matches(r_word, p_word)
            f = _fscore(m_char, m_word, hyp_char, hyp_word, ref_char, ref_word, n_order, beta)
            if f > best[0]:
                best = (f, (m_char, m_word, ref_char, ref_word))

        f, (m_char, m_word, ref_char, ref_word) = best
        stats.matching_char += m_char
        stats.matching_word += m_word
        stats.preds_char += hyp_char
        stats.preds_word += hyp_word
        stats.target_char += ref_char
        stats.target_word += ref_word
        if sentence_scores is not None:
            sentence_scores.append(f)


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Corpus chrF/chrF++, float32 (and the sentence scores)."""
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError("Expected argument `n_char_order` to be an integer greater than or equal to 1.")
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError("Expected argument `n_word_order` to be an integer greater than or equal to 0.")
    if beta < 0:
        raise ValueError("Expected argument `beta` to be greater than 0.")

    stats = _ChrFStats(n_char_order, n_word_order)
    sentence_scores: Optional[List[float]] = [] if return_sentence_level_score else None
    _chrf_score_update(
        preds, target, stats, n_char_order, n_word_order, beta, lowercase, whitespace, sentence_scores
    )
    n_order = float(n_char_order + n_word_order)
    corpus = _fscore(
        stats.matching_char, stats.matching_word,
        stats.preds_char, stats.preds_word,
        stats.target_char, stats.target_word,
        n_order, beta,
    )
    if return_sentence_level_score:
        return torch.tensor(corpus, dtype=torch.float32), torch.tensor(sentence_scores, dtype=torch.float32)
    return torch.tensor(corpus, dtype=torch.float32)
