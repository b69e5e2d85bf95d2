"""Translation Edit Rate (counterpart of ``torchmetrics_tpu/functional/text/ter.py``).

Tercom algorithm: tokenize (tercom rules), then repeatedly apply the
best-scoring block shift until no shift lowers the word edit distance;
TER = (shifts + edits) / avg reference length. The alignment DP is a full
vectorized numpy Levenshtein with backtrace. All of it is host Python and
numpy, copied from the JAX package; the sums become float32 tensors.

Example::

    >>> from torchmetrics_tpu_torch.functional.text.ter import translation_edit_rate
    >>> preds = ['the cat is on the mat']
    >>> target = [['the cat is playing on the mat']]
    >>> round(float(translation_edit_rate(preds, target)), 4)
    0.1429
"""

from __future__ import annotations

import re
from functools import lru_cache
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.helper import _edit_distance

_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50
_MAX_SHIFT_CANDIDATES = 1000


# Tercom normalization tables (the rules are fixed by the tercom spec and
# sacrebleu's TercomTokenizer), compiled once at import.
_WESTERN_NORMALIZE: Tuple[Tuple["re.Pattern", str], ...] = tuple(
    (re.compile(pat), rep)
    for pat, rep in [
        (r"\n-", ""),                      # join hyphenated line breaks
        (r"\n", " "),
        (r"&quot;", '"'),                  # unescape the four XML entities
        (r"&amp;", "&"),
        (r"&lt;", "<"),
        (r"&gt;", ">"),
        (r"([{-~[-` -&(-+:-@/])", r" \1 "),  # split out ASCII symbols
        (r"'s ", r" 's "),                 # possessive clitics
        (r"'s$", r" 's"),
        (r"([^0-9])([\.,])", r"\1 \2 "),   # . and , adjacent to non-digits
        (r"([\.,])([^0-9])", r" \1 \2"),
        (r"([0-9])(-)", r"\1 \2 "),        # dash after a digit
    ]
)
_ASIAN_SEPARATE: Tuple["re.Pattern", ...] = tuple(
    re.compile(p)
    for p in (
        r"([\u4e00-\u9fff\u3400-\u4dbf])",  # CJK unified ideographs (+ext A)
        r"([\u31c0-\u31ef\u2e80-\u2eff])",  # strokes / radicals supplement
        r"([\u3300-\u33ff\uf900-\ufaff\ufe30-\ufe4f])",  # squared abbrev., compat ideographs, vertical forms
        r"([\u3200-\u3f22])",                # enclosed CJK letters
    )
)
_ASIAN_PUNCT = re.compile(r"([\u3001\u3002\u3008-\u3011\u3014-\u301f\uff61-\uff65\u30fb])")
_FULL_WIDTH_PUNCT = re.compile(r"([\uff0e\uff0c\uff1f\uff1a\uff1b\uff01\uff02\uff08\uff09])")
_PUNCT = re.compile(r"[\.,\?:;!\"\(\)]")


class _TercomTokenizer:
    """Tercom sentence normalizer, configured once and cached per sentence.

    Pipeline (each stage optional): lowercase -> western normalization
    (+ asian ideograph separation) -> punctuation removal (+ asian
    punctuation) -> whitespace squeeze; table-driven.
    """

    def __init__(
        self,
        normalize: bool = False,
        no_punctuation: bool = False,
        lowercase: bool = True,
        asian_support: bool = False,
    ) -> None:
        self.normalize = normalize
        self.no_punctuation = no_punctuation
        self.lowercase = lowercase
        self.asian_support = asian_support

    @lru_cache(maxsize=2**16)  # noqa: B019
    def __call__(self, sentence: str) -> str:
        if not sentence:
            return ""
        if self.lowercase:
            sentence = sentence.lower()
        if self.normalize:
            sentence = f" {sentence} "
            for pattern, repl in _WESTERN_NORMALIZE:
                sentence = pattern.sub(repl, sentence)
            if self.asian_support:
                for pattern in _ASIAN_SEPARATE + (_ASIAN_PUNCT, _FULL_WIDTH_PUNCT):
                    sentence = pattern.sub(r" \1 ", sentence)
        if self.no_punctuation:
            sentence = _PUNCT.sub("", sentence)
            if self.asian_support:
                sentence = _FULL_WIDTH_PUNCT.sub("", _ASIAN_PUNCT.sub("", sentence))
        return " ".join(sentence.split())


def _preprocess_sentence(sentence: str, tokenizer: _TercomTokenizer) -> str:
    return tokenizer(sentence.rstrip())


def _alignment(
    a: List[str], b: List[str]
) -> Tuple[int, Dict[int, int], List[int], List[int]]:
    """Edit distance + alignment of ``b`` positions to ``a`` positions.

    Returns (distance, alignments {b_pos: a_pos}, b_errors, a_errors) — the
    combined result of a trace, flip and align, computed directly from one
    backtrace. Tie preference: match/substitute, then consume-a, then
    consume-b, so that the shift ranking agrees with tercom's.
    """
    m, n = len(a), len(b)
    d = np.zeros((m + 1, n + 1), dtype=np.int64)
    d[:, 0] = np.arange(m + 1)
    d[0, :] = np.arange(n + 1)
    if m and n:
        b_arr = np.asarray(b, dtype=object)
        ar = np.arange(n + 1, dtype=np.int64)
        c = np.empty(n + 1, dtype=np.int64)
        for i, ai in enumerate(a, 1):
            prev = d[i - 1]
            c[0] = i
            c[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (b_arr != ai))
            d[i] = np.minimum.accumulate(c - ar) + ar

    alignments: Dict[int, int] = {}
    a_err = [0] * m
    b_err = [0] * n
    i, j = m, n
    while i > 0 or j > 0:
        if i > 0 and j > 0 and a[i - 1] == b[j - 1] and d[i, j] == d[i - 1, j - 1]:
            i, j = i - 1, j - 1
            alignments[j] = i
        elif i > 0 and j > 0 and d[i, j] == d[i - 1, j - 1] + 1:
            i, j = i - 1, j - 1
            alignments[j] = i
            a_err[i] = 1
            b_err[j] = 1
        elif i > 0 and d[i, j] == d[i - 1, j] + 1:
            i -= 1
            a_err[i] = 1
        else:
            j -= 1
            alignments[j] = i - 1
            b_err[j] = 1
    return int(d[m, n]), alignments, b_err, a_err


def _matching_blocks(pred_words: List[str], target_words: List[str]) -> Iterator[Tuple[int, int, int]]:
    """Every equal word block between hypothesis and reference, as
    ``(pred_start, target_start, length)`` — the shift candidates of the
    tercom spec (block length capped at ``_MAX_SHIFT_SIZE - 1`` words, start
    offset at ``_MAX_SHIFT_DIST``)."""
    n_pred, n_tgt = len(pred_words), len(target_words)
    for p in range(n_pred):
        t_lo = max(0, p - _MAX_SHIFT_DIST)
        t_hi = min(n_tgt, p + _MAX_SHIFT_DIST + 1)
        for t in range(t_lo, t_hi):
            longest = min(_MAX_SHIFT_SIZE - 1, n_pred - p, n_tgt - t)
            for k in range(longest):
                if pred_words[p + k] != target_words[t + k]:
                    break
                yield p, t, k + 1


def _perform_shift(words: List[str], start: int, length: int, target: int) -> List[str]:
    """Cut the block ``words[start:start+length]`` and reinsert it at
    ``target`` (a position in the pre-shift list; tercom shift semantics)."""
    block = words[start : start + length]
    rest = words[:start] + words[start + length :]
    at = target - length if target > start + length else target
    return rest[:at] + block + rest[at:]


def _insertion_points(alignments: Dict[int, int], target_start: int, length: int) -> Iterator[int]:
    """Hypothesis positions where a block aimed at ``target_start`` may land.

    One anchor per reference slot from just before the block through its
    last word: the hypothesis position aligned to that slot, plus one.  An
    unaligned slot ends the anchor walk; consecutive duplicates collapse.
    """
    last = None
    for t_pos in range(target_start - 1, target_start + length):
        if t_pos < 0:
            idx = 0
        elif t_pos in alignments:
            idx = alignments[t_pos] + 1
        else:
            return
        if idx != last:
            last = idx
            yield idx


def _shift_words(
    pred_words: List[str],
    target_words: List[str],
    checked_candidates: int,
) -> Tuple[int, List[str], int]:
    """One round of the tercom greedy shift search.

    Every matching block that (a) is misplaced in the hypothesis, (b) covers
    a still-unsatisfied reference span, and (c) would not land inside
    itself, is tried at each anchored insertion point.  Candidates rank
    lexicographically by (edit-distance gain, block length, earlier block,
    earlier landing spot); the winner's gain and shifted hypothesis are
    returned. Semantics follow the tercom spec.
    """
    base_distance, alignments, target_errors, pred_errors = _alignment(pred_words, target_words)

    best_key: Optional[Tuple[int, int, int, int]] = None
    best_words = pred_words
    for p_start, t_start, length in _matching_blocks(pred_words, target_words):
        block_misplaced = any(pred_errors[p_start : p_start + length])
        span_unsatisfied = any(target_errors[t_start : t_start + length])
        lands_in_itself = p_start <= alignments[t_start] < p_start + length
        if not block_misplaced or not span_unsatisfied or lands_in_itself:
            continue

        for idx in _insertion_points(alignments, t_start, length):
            shifted = _perform_shift(pred_words, p_start, length, idx)
            gain = base_distance - _edit_distance(shifted, target_words)
            key = (gain, length, -p_start, -idx)
            checked_candidates += 1
            if best_key is None or key > best_key:
                best_key, best_words = key, shifted
        if checked_candidates >= _MAX_SHIFT_CANDIDATES:
            break

    if best_key is None:
        return 0, pred_words, checked_candidates
    return best_key[0], best_words, checked_candidates


def _translation_edit_rate(pred_words: List[str], target_words: List[str]) -> float:
    """Shifts + edits for one (hyp, ref) pair."""
    if len(target_words) == 0:
        return 0.0
    num_shifts = 0
    checked_candidates = 0
    input_words = pred_words
    while True:
        delta, new_input_words, checked_candidates = _shift_words(
            input_words, target_words, checked_candidates
        )
        if checked_candidates >= _MAX_SHIFT_CANDIDATES or delta <= 0:
            break
        num_shifts += 1
        input_words = new_input_words
    return float(num_shifts + _edit_distance(input_words, target_words))


def _compute_sentence_statistics(
    pred_words: List[str], target_words: List[List[str]]
) -> Tuple[float, float]:
    """Best edits over references + avg ref length (``_translation_edit_rate``
    takes ``(tgt_words, pred_words)``, the roles swapped, as in the JAX package)."""
    tgt_lengths = 0.0
    best_num_edits = float("inf")
    for tgt_words in target_words:
        num_edits = _translation_edit_rate(tgt_words, pred_words)
        tgt_lengths += len(tgt_words)
        if num_edits < best_num_edits:
            best_num_edits = num_edits
    avg_tgt_len = tgt_lengths / len(target_words)
    return best_num_edits, avg_tgt_len


def _compute_ter_score_from_statistics(num_edits: float, tgt_length: float) -> float:
    if tgt_length > 0 and num_edits > 0:
        return num_edits / tgt_length
    if tgt_length == 0 and num_edits > 0:
        return 1.0
    return 0.0


def _corpus_statistics(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    tokenizer: _TercomTokenizer,
) -> Tuple[float, float, List[float]]:
    """Tokenize a (hypotheses, multi-reference) corpus and total its tercom
    statistics: ``(edits, avg-ref-length, per-sentence TER)`` summed/listed
    over sentences."""
    hyp_list = [preds] if isinstance(preds, str) else list(preds)
    ref_lists = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(hyp_list) != len(ref_lists):
        raise ValueError(
            f"Got {len(hyp_list)} hypotheses but {len(ref_lists)} reference sets — "
            "the corpus sides must pair up one-to-one."
        )

    edits_total = 0.0
    ref_len_total = 0.0
    per_sentence: List[float] = []
    for hyp, refs in zip(hyp_list, ref_lists):
        hyp_words = _preprocess_sentence(hyp, tokenizer).split()
        ref_words = [_preprocess_sentence(r, tokenizer).split() for r in refs]
        edits, ref_len = _compute_sentence_statistics(hyp_words, ref_words)
        edits_total += edits
        ref_len_total += ref_len
        per_sentence.append(_compute_ter_score_from_statistics(edits, ref_len))
    return edits_total, ref_len_total, per_sentence


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Corpus TER, float32 (and the sentence scores)."""
    flags = {
        "normalize": normalize,
        "no_punctuation": no_punctuation,
        "lowercase": lowercase,
        "asian_support": asian_support,
    }
    for name, value in flags.items():
        if not isinstance(value, bool):
            raise ValueError(f"`{name}` must be a bool, got {value!r}.")

    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    edits_total, ref_len_total, per_sentence = _corpus_statistics(preds, target, tokenizer)
    score = _compute_ter_score_from_statistics(edits_total, ref_len_total)
    if return_sentence_level_score:
        return torch.tensor(score, dtype=torch.float32), torch.tensor(per_sentence, dtype=torch.float32)
    return torch.tensor(score, dtype=torch.float32)
