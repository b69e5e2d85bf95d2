"""Word and character error rates: WER, CER, MER, WIL, WIP and the edit distance
(counterpart of ``torchmetrics_tpu/functional/text/asr.py``).

The token dynamic programs are host Python and numpy, copied from the JAX
package; each update gives its sums as float32 scalars (the edit distance
int32 distances), the only tensors. The functional forms return CPU tensors.
WIL and WIP keep hits = sum of max(len) - sum of edits, as the JAX package does.

Example::

    >>> from torchmetrics_tpu_torch.functional.text.asr import word_error_rate, char_error_rate
    >>> preds = ['this is the prediction', 'there is an other sample']
    >>> target = ['this is the reference', 'there is another one']
    >>> round(float(word_error_rate(preds, target)), 4)
    0.5
    >>> round(float(char_error_rate(preds, target)), 4)
    0.3415
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.helper import _edit_distance


def _as_list(x: Union[str, List[str]]) -> List[str]:
    return [x] if isinstance(x, str) else list(x)


def _sums(*values: float, device: Optional[torch.device] = None) -> Tuple[Tensor, ...]:
    """Host sums as float32 scalars on ``device`` (the CPU by default)."""
    return tuple(torch.tensor(float(v), dtype=torch.float32, device=device) for v in values)


def _wer_update(preds, target, device: Optional[torch.device] = None) -> Tuple[Tensor, Tensor]:
    errors = total = 0
    for pred, tgt in zip(_as_list(preds), _as_list(target)):
        p, t = pred.split(), tgt.split()
        errors += _edit_distance(p, t)
        total += len(t)
    return _sums(errors, total, device=device)


def word_error_rate(preds, target) -> Tensor:
    errors, total = _wer_update(preds, target)
    return errors / total


def _cer_update(preds, target, device: Optional[torch.device] = None) -> Tuple[Tensor, Tensor]:
    errors = total = 0
    for pred, tgt in zip(_as_list(preds), _as_list(target)):
        errors += _edit_distance(list(pred), list(tgt))
        total += len(tgt)
    return _sums(errors, total, device=device)


def char_error_rate(preds, target) -> Tensor:
    errors, total = _cer_update(preds, target)
    return errors / total


def _mer_update(preds, target, device: Optional[torch.device] = None) -> Tuple[Tensor, Tensor]:
    errors = total = 0
    for pred, tgt in zip(_as_list(preds), _as_list(target)):
        p, t = pred.split(), tgt.split()
        errors += _edit_distance(p, t)
        total += max(len(t), len(p))
    return _sums(errors, total, device=device)


def match_error_rate(preds, target) -> Tensor:
    errors, total = _mer_update(preds, target)
    return errors / total


def _wil_wip_update(preds, target, device: Optional[torch.device] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (hits, target_total, preds_total); hits = sum of max(len) - sum of edits."""
    edits = total = target_total = preds_total = 0
    for pred, tgt in zip(_as_list(preds), _as_list(target)):
        p, t = pred.split(), tgt.split()
        edits += _edit_distance(p, t)
        target_total += len(t)
        preds_total += len(p)
        total += max(len(t), len(p))
    return _sums(total - edits, target_total, preds_total, device=device)


def word_information_preserved(preds, target) -> Tensor:
    hits, tt, pt = _wil_wip_update(preds, target)
    return (hits / tt) * (hits / pt)


def word_information_lost(preds, target) -> Tensor:
    return 1.0 - word_information_preserved(preds, target)


def _edit_update(preds, target, substitution_cost: int = 1) -> List[int]:
    preds_l, target_l = _as_list(preds), _as_list(target)
    if len(preds_l) != len(target_l):
        raise ValueError(
            f"Expected argument `preds` and `target` to have same length, but got {len(preds_l)} and {len(target_l)}"
        )
    return [_edit_distance(list(pred), list(tgt), substitution_cost) for pred, tgt in zip(preds_l, target_l)]


def edit_distance(preds, target, substitution_cost: int = 1, reduction: Optional[str] = "mean") -> Tensor:
    """Char-level Levenshtein distance: int32 distances, their sum, or their float32 mean."""
    dists = torch.tensor(_edit_update(preds, target, substitution_cost), dtype=torch.int32)
    if reduction == "mean":
        return dists.to(torch.float32).mean()
    if reduction == "sum":
        return dists.sum(dtype=torch.int32)
    if reduction is None or reduction == "none":
        return dists
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")
