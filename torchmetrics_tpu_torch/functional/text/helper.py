"""Text helpers: edit distances, n-gram counting and longest common subsequences.

Counterpart of ``torchmetrics_tpu/functional/text/helper.py``, copied: the
functions are pure Python and numpy. Strings never reach the device;
tokenization, the edit-distance and LCS tables run on the host, and only the
per-sample statistics become metric state.
"""

from __future__ import annotations

from collections import Counter
from typing import Sequence

import numpy as np


def _edit_distance(a: Sequence, b: Sequence, substitution_cost: int = 1) -> int:
    """Levenshtein distance between two token sequences.

    Row recurrence vectorized: cur[j] = min(prev[j]+1, prev[j-1]+sub, cur[j-1]+1);
    the cur[j-1]+1 chain is a prefix-min of (candidate - j), done with one
    ``np.minimum.accumulate`` per row.
    """
    m, n = len(a), len(b)
    if m == 0:
        return n
    if n == 0:
        return m
    b_arr = np.asarray(list(b), dtype=object)
    ar = np.arange(n + 1, dtype=np.float64)
    prev = ar.copy()
    c = np.empty(n + 1, dtype=np.float64)
    for i, ai in enumerate(a, 1):
        c[0] = i
        c[1:] = np.minimum(prev[1:] + 1.0, prev[:-1] + substitution_cost * (b_arr != ai))
        prev = np.minimum.accumulate(c - ar) + ar
    return int(prev[-1])


def _edit_distance_matrix(a: Sequence, b: Sequence) -> np.ndarray:
    """Full (m+1, n+1) Levenshtein DP table (needed by TER's shift search)."""
    m, n = len(a), len(b)
    d = np.zeros((m + 1, n + 1), dtype=np.float64)
    d[:, 0] = np.arange(m + 1)
    d[0, :] = np.arange(n + 1)
    if m == 0 or n == 0:
        return d
    b_arr = np.asarray(list(b), dtype=object)
    ar = np.arange(n + 1, dtype=np.float64)
    c = np.empty(n + 1, dtype=np.float64)
    for i, ai in enumerate(a, 1):
        prev = d[i - 1]
        c[0] = i
        c[1:] = np.minimum(prev[1:] + 1.0, prev[:-1] + (b_arr != ai))
        d[i] = np.minimum.accumulate(c - ar) + ar
    return d


def _count_ngram(tokens: Sequence[str], n_gram: int) -> Counter:
    """Counter over all 1..n_gram-grams (reference bleu.py:_count_ngram)."""
    counter: Counter = Counter()
    for n in range(1, n_gram + 1):
        for i in range(len(tokens) - n + 1):
            counter[tuple(tokens[i : i + n])] += 1
    return counter


def _lcs_length(a: Sequence, b: Sequence) -> int:
    """Longest-common-subsequence length (ROUGE-L), vectorized per row."""
    m, n = len(a), len(b)
    if m == 0 or n == 0:
        return 0
    b_arr = np.asarray(list(b), dtype=object)
    prev = np.zeros(n + 1, dtype=np.int64)
    for ai in a:
        cur = np.empty(n + 1, dtype=np.int64)
        cur[0] = 0
        match = prev[:-1] + (b_arr == ai)
        # cur[j] = max(match[j-1], prev[j], cur[j-1]) — running max scan
        cur[1:] = np.maximum(match, prev[1:])
        np.maximum.accumulate(cur, out=cur)
        prev = cur
    return int(prev[-1])


def _lcs_table(a: Sequence, b: Sequence) -> np.ndarray:
    """Full LCS DP table for backtracking union-LCS (ROUGE-Lsum)."""
    m, n = len(a), len(b)
    d = np.zeros((m + 1, n + 1), dtype=np.int64)
    if m == 0 or n == 0:
        return d
    b_arr = np.asarray(list(b), dtype=object)
    for i, ai in enumerate(a, 1):
        match = d[i - 1, :-1] + (b_arr == ai)
        cur = np.maximum(match, d[i - 1, 1:])
        np.maximum.accumulate(cur, out=cur)
        d[i, 1:] = cur
        d[i, 0] = 0
    return d


def _lcs_members(a: Sequence, b: Sequence) -> set:
    """Indices of ``b`` participating in one LCS of a/b (for union-LCS)."""
    d = _lcs_table(a, b)
    i, j = len(a), len(b)
    members = set()
    while i > 0 and j > 0:
        if a[i - 1] == b[j - 1] and d[i, j] == d[i - 1, j - 1] + 1:
            members.add(j - 1)
            i -= 1
            j -= 1
        elif d[i - 1, j] >= d[i, j - 1]:
            i -= 1
        else:
            j -= 1
    return members
