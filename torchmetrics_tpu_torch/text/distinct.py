"""Distinct n-gram ratio over token-id streams (counterpart of ``torchmetrics_tpu/text/distinct.py``), the
exact path.

The state is a cat list of ``(windows, n)`` int32 n-gram rows (a window
holding ``ignore_index`` rewritten to a sentinel row) and the float32 count of
valid windows; ``compute`` sorts the rows lexicographically and counts the
changes. The JAX package's ``approx="sketch"`` (a HyperLogLog) is not
ported: the base class refuses ``approx``.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.text import DistinctNGrams
    >>> metric = DistinctNGrams(ngram=2, device="cpu")
    >>> metric.update(torch.tensor([[3, 5, 3, 5, 3]]))
    >>> round(float(metric.compute()), 4)  # windows: (3,5) (5,3) (3,5) (5,3)
    0.5
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import Metric, State
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

#: the token of an invalid window's row in the cat state
_SENTINEL = -1


class DistinctNGrams(Metric):
    """Fraction of generated n-grams that are distinct (type/token ratio).

    Args:
        ngram: window length (1 = distinct tokens).
        ignore_index: token id to treat as padding; windows containing it
            are excluded from both the distinct and total counts.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, ngram: int = 1, ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(ngram, int) and ngram >= 1):
            raise ValueError(f"Argument `ngram` expected to be an integer >= 1, but got {ngram}")
        self.ngram = ngram
        self.ignore_index = ignore_index
        self.add_state("ngrams", [], dist_reduce_fx="cat")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def _windows(self, tokens: Any) -> Tuple[Tensor, Tensor]:
        """``(rows, n)`` stacked n-gram windows and the ``(rows,)`` validity mask."""
        tokens = torch.atleast_2d(self._tensor(tokens).to(torch.int32))
        if tokens.shape[-1] < self.ngram:
            raise ValueError(
                f"DistinctNGrams(ngram={self.ngram}) needs sequences of at least {self.ngram} "
                f"tokens, got shape {tuple(tokens.shape)}"
            )
        win = tokens.unfold(-1, self.ngram, 1).reshape(-1, self.ngram)
        if self.ignore_index is None:
            valid = torch.ones((win.shape[0],), dtype=torch.bool, device=win.device)
        else:
            valid = (win != self.ignore_index).all(dim=-1)
        return win, valid

    def _update(self, state: State, preds: Any) -> State:
        win, valid = self._windows(preds)
        win = torch.where(valid[:, None], win, _SENTINEL)
        return {"ngrams": tuple(state["ngrams"]) + (win,), "total": state["total"] + valid.sum()}

    def _compute(self, state: State) -> Tensor:
        total = torch.clamp_min(state["total"], 1.0)
        rows = dim_zero_cat(state["ngrams"])  # (rows, n)
        # lexicographic order: stable sorts from the last column to the first; sentinel rows group together
        order = torch.arange(rows.shape[0], device=rows.device)
        for col in range(rows.shape[1] - 1, -1, -1):
            order = order[torch.argsort(rows[order, col], stable=True)]
        srt = rows[order]
        valid = srt[:, 0] != _SENTINEL
        changed = torch.cat([torch.ones((1,), dtype=torch.bool, device=rows.device), (srt[1:] != srt[:-1]).any(-1)])
        return (changed & valid).sum() / total
