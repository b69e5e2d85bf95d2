"""Extended Edit Distance (counterpart of ``torchmetrics_tpu/functional/text/eed.py``).

EED = CDER-style character DP with an α-penalized jump at blank positions and
a ρ coverage penalty.  The substitution/insertion candidates of each DP row
are vectorized in numpy; the deletion chain is deliberately sequential so
float rounding and tie-breaks (which feed min_index and the jump) match the
JAX package's operation order exactly: do not re-vectorize it as a prefix-min.
The DP is host Python and numpy, copied; the sentence scores become float32
tensors.

Example::

    >>> from torchmetrics_tpu_torch.functional.text.eed import extended_edit_distance
    >>> preds = ['this is the prediction', 'here is an other sample']
    >>> target = ['this is the reference', 'here is another one']
    >>> round(float(extended_edit_distance(preds, target)), 4)
    0.3078
"""

from __future__ import annotations

import re
import unicodedata
from math import inf
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor


def _eed_function(
    hyp: str,
    ref: str,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """Sentence-level EED (an order-exact DP)."""
    nh = len(hyp)
    hyp_arr = np.frombuffer(hyp.encode("utf-32-le"), dtype=np.uint32) if nh else np.zeros(0, np.uint32)
    number_of_visits = np.full(nh + 1, -1, dtype=np.int64)
    row = np.ones(nh + 1, dtype=np.float64)
    row[0] = 0.0
    idx = np.arange(nh + 1, dtype=np.float64)

    for w in range(1, len(ref) + 1):
        ch = ord(ref[w - 1])
        sub_cost = (hyp_arr != ch).astype(np.float64)
        cand = np.empty(nh + 1, dtype=np.float64)
        cand[0] = row[0] + 1.0
        cand[1:] = np.minimum(row[:-1] + sub_cost, row[1:] + insertion)
        # deletion chain: next[i] = min(next[i-1]+deletion, cand[i]).  Run it
        # sequentially so float rounding (and hence tie-breaks feeding
        # min_index / the jump) matches the JAX package's operation order — a
        # prefix-min reformulation changes ULPs and can flip the alignment.
        next_row = cand
        prev = next_row[0]
        for i in range(1, nh + 1):
            d = prev + deletion
            if d < next_row[i]:
                next_row[i] = d
            prev = next_row[i]
        min_index = int(np.argmin(next_row))
        number_of_visits[min_index] += 1
        if ref[w - 1] == " ":
            jump = alpha + next_row[min_index]
            next_row = np.minimum(next_row, jump)
        row = next_row

    coverage = rho * float(np.where(number_of_visits >= 0, number_of_visits, 1).sum())
    return min(1.0, (row[-1] + coverage) / (float(len(ref)) + coverage))


def _preprocess_en(sentence: str) -> str:
    """EED English normalization."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    for pattern, replacement in ((".", " ."), ("!", " !"), ("?", " ?"), (",", " ,")):
        sentence = sentence.replace(pattern, replacement)
    rules_re = [
        (r"\s+", r" "),
        (r"(\d) ([.,]) (\d)", r"\1\2\3"),
        (r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1."),
    ]
    for pattern, replacement in rules_re:
        sentence = re.sub(pattern, replacement, sentence)
    for pattern, replacement in (("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")):
        sentence = sentence.replace(pattern, replacement)
    return " " + sentence + " "


def _preprocess_ja(sentence: str) -> str:
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _eed_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    sentence_eed: Optional[List[float]] = None,
) -> List[float]:
    """Each sentence's best score over its references."""
    preds_ = [preds] if isinstance(preds, str) else list(preds)
    target_ = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    if language == "en":
        fn = _preprocess_en
    elif language == "ja":
        fn = _preprocess_ja
    else:
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")

    if sentence_eed is None:
        sentence_eed = []
    if 0 in (len(preds_), len(target_[0]) if target_ else 0):
        return sentence_eed

    for pred, refs in zip(preds_, target_):
        p = fn(pred)
        best = inf
        for ref in refs:
            score = _eed_function(p, fn(ref), alpha, rho, deletion, insertion)
            best = min(best, score)
        sentence_eed.append(best)
    return sentence_eed


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Corpus EED = mean sentence EED, float32."""
    for name, val in (("alpha", alpha), ("rho", rho), ("deletion", deletion), ("insertion", insertion)):
        if not isinstance(val, float):
            raise ValueError(f"Expected argument `{name}` to be of type float but got {val}.")
    scores = _eed_update(preds, target, language, alpha, rho, deletion, insertion)
    avg = torch.tensor(float(np.mean(scores)) if scores else 0.0, dtype=torch.float32)
    if return_sentence_level_score:
        return avg, torch.tensor(scores, dtype=torch.float32)
    return avg
