"""SQuAD v1.1 Exact-Match / F1 (counterpart of ``torchmetrics_tpu/functional/text/squad.py``).

Official normalization (lowercase, strip punctuation and articles) and the
max over ground truths, host Python copied from the JAX package, accumulated
as three float32 sums.

Example::

    >>> from torchmetrics_tpu_torch.functional.text.squad import squad
    >>> preds = [{'prediction_text': '1976', 'id': '56e10a3be3433e1400422b22'}]
    >>> target = [{'answers': {'answer_start': [97], 'text': ['1976']}, 'id': '56e10a3be3433e1400422b22'}]
    >>> {k: float(v) for k, v in sorted(squad(preds, target).items())}
    {'exact_match': 100.0, 'f1': 100.0}
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Any, Dict, List, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

PREDS_TYPE = Union[Dict[str, str], List[Dict[str, str]]]
TARGETS_TYPE = Union[Dict[str, Any], List[Dict[str, Any]]]


def _normalize_text(s: str) -> str:
    """Lower, strip punctuation/articles/extra whitespace."""

    def remove_articles(text: str) -> str:
        return re.sub(r"\b(a|an|the)\b", " ", text)

    def white_space_fix(text: str) -> str:
        return " ".join(text.split())

    def remove_punc(text: str) -> str:
        exclude = set(string.punctuation)
        return "".join(ch for ch in text if ch not in exclude)

    return white_space_fix(remove_articles(remove_punc(s.lower())))


def _get_tokens(s: str) -> List[str]:
    return _normalize_text(s).split() if s else []


def _compute_f1_score(prediction: str, ground_truth: str) -> float:
    pred_toks = _get_tokens(prediction)
    gt_toks = _get_tokens(ground_truth)
    common = Counter(pred_toks) & Counter(gt_toks)
    num_same = sum(common.values())
    if len(gt_toks) == 0 or len(pred_toks) == 0:
        return float(gt_toks == pred_toks)
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_toks)
    recall = num_same / len(gt_toks)
    return 2 * precision * recall / (precision + recall)


def _compute_exact_match_score(prediction: str, ground_truth: str) -> float:
    return float(_normalize_text(prediction) == _normalize_text(ground_truth))


def _metric_max_over_ground_truths(metric_fn, prediction: str, ground_truths: List[str]) -> float:
    return max(metric_fn(prediction, gt) for gt in ground_truths)


def _squad_input_check(
    preds: PREDS_TYPE, targets: TARGETS_TYPE
) -> Tuple[Dict[str, str], List[Dict[str, List[Dict[str, Any]]]]]:
    """Normalize inputs to the internal (preds_dict, articles) form."""
    if isinstance(preds, dict):
        preds = [preds]
    if isinstance(targets, dict):
        targets = [targets]
    for pred in preds:
        keys = pred.keys()
        if "prediction_text" not in keys or "id" not in keys:
            raise KeyError(
                "Expected keys in a single prediction are 'prediction_text' and 'id'. "
                "Please make sure that 'prediction_text' maps to the answer string and 'id' maps to the key string."
            )
    for target in targets:
        keys = target.keys()
        if "answers" not in keys or "id" not in keys:
            raise KeyError(
                "Expected keys in a single target are 'answers' and 'id'. "
                "Please make sure that 'answers' maps to a `SQuAD` format dictionary and 'id' maps to the key string."
            )
        if "text" not in target["answers"]:
            raise KeyError(
                "Expected keys in a 'answers' are 'text'. "
                "Please make sure that 'text' maps to a list of strings."
            )
    preds_dict = {p["id"]: p["prediction_text"] for p in preds}
    articles = [
        {"paragraphs": [{"qas": [
            {"answers": [{"text": txt} for txt in t["answers"]["text"]], "id": t["id"]}
            for t in targets
        ]}]}
    ]
    return preds_dict, articles


def _squad_update(
    preds: Dict[str, str],
    target: List[Dict[str, Any]],
) -> Tuple[Tensor, Tensor, Tensor]:
    """Sum F1/EM/total over all questions, as float32 scalars (int32 total) on the CPU."""
    f1 = 0.0
    exact_match = 0.0
    total = 0
    for article in target:
        for paragraph in article["paragraphs"]:
            for qa in paragraph["qas"]:
                total += 1
                if qa["id"] not in preds:
                    rank_zero_warn(f"Unanswered question {qa['id']} will receive score 0.")
                    continue
                ground_truths = [x["text"] for x in qa["answers"]]
                pred = preds[qa["id"]]
                exact_match += _metric_max_over_ground_truths(_compute_exact_match_score, pred, ground_truths)
                f1 += _metric_max_over_ground_truths(_compute_f1_score, pred, ground_truths)
    return torch.tensor(f1, dtype=torch.float32), torch.tensor(exact_match, dtype=torch.float32), torch.tensor(total, dtype=torch.int32)


def _squad_compute(f1: Tensor, exact_match: Tensor, total: Tensor) -> Dict[str, Tensor]:
    return {
        "exact_match": 100.0 * exact_match / total,
        "f1": 100.0 * f1 / total,
    }


def squad(preds: PREDS_TYPE, target: TARGETS_TYPE) -> Dict[str, Tensor]:
    """SQuAD EM/F1."""
    preds_dict, articles = _squad_input_check(preds, target)
    f1, em, total = _squad_update(preds_dict, articles)
    return _squad_compute(f1, em, total)
