"""Distinct n-gram ratio over token-id streams (counterpart of ``torchmetrics_tpu/text/distinct.py``).

Two modes:

* exact (default): a cat list of ``(windows, n)`` int32 n-gram rows (a window
  holding ``ignore_index`` rewritten to a sentinel row) and the float32 count
  of valid windows; ``compute`` sorts the rows lexicographically and counts
  the changes;
* ``approx="sketch"``: a fixed :class:`~torchmetrics_tpu_torch.sketches.HyperLogLog`
  register array (``max``-merged, one ``all_reduce``) beside the window
  count, ``~1.04 / sqrt(2**precision)`` relative error on the distinct count
  (precision 11 by default, or sized from ``approx_error``). On the card an
  update is one launch of the ``hll_insert`` kernel (``csrc/hll.cu``), which
  forms the windows, hashes them and maxes the registers in place; on the CPU
  the plain version, JAX's form.

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
from torchmetrics_tpu_torch.kernels.hll import _hll_insert_plain, hll_insert
from torchmetrics_tpu_torch.sketches.cardinality import HyperLogLog, mix32
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat

#: the token of an invalid window's row in the cat state
_SENTINEL = -1
#: the salt of the k-th token of a window's key chain: 0x9E3779B9 * (k + 1), wrapped to 32 bits
KEY_SALT = 0x9E3779B9


def ngram_windows(tokens: Tensor, ngram: int, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor]:
    """The ``(rows, n)`` n-gram windows of ``(..., T)`` tokens along their last axis and whether each holds no
    ``ignore_index``; no windows where T < n."""
    if tokens.shape[-1] < ngram:
        return (torch.zeros((0, ngram), dtype=tokens.dtype, device=tokens.device),
                torch.zeros((0,), dtype=torch.bool, device=tokens.device))
    win = tokens.unfold(-1, ngram, 1).reshape(-1, ngram)
    if ignore_index is None:
        return win, torch.ones((win.shape[0],), dtype=torch.bool, device=win.device)
    return win, (win.to(torch.int64) != ignore_index).all(dim=-1)


def window_keys(tokens: Tensor, ngram: int, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor]:
    """Each window's key (int64 values in ``[0, 2**32)``: ``h = mix32(token + h, KEY_SALT * (k + 1))`` over its
    tokens) and whether it holds no ``ignore_index`` (:func:`ngram_windows`)."""
    win, valid = ngram_windows(tokens, ngram, ignore_index)
    h = torch.zeros((win.shape[0],), dtype=torch.int64, device=win.device)
    for k in range(ngram):
        h = mix32((win[:, k].to(torch.int64) & 0xFFFFFFFF) + h, (KEY_SALT * (k + 1)) & 0xFFFFFFFF)
    return h, valid


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

    #: HyperLogLog when ``approx="sketch"`` replaced the cat state
    _hll: Optional[HyperLogLog] = None

    def __init__(self, ngram: int = 1, ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(ngram, int) and ngram >= 1):
            raise ValueError(f"Argument `ngram` expected to be an integer >= 1, but got {ngram}")
        self.ngram = ngram
        self.ignore_index = ignore_index
        if self.approx == "sketch":
            self._hll = HyperLogLog.for_error(self.approx_error)
            self._inplace_leaves = ("registers",)  # the kernel maxes the registers in place
            self.add_state("registers", self._hll.init(), dist_reduce_fx=self._hll.reduce_spec)
        else:
            self.add_state("ngrams", [], dist_reduce_fx="cat")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def _tokens(self, tokens: Any) -> Tensor:
        """``(B, T)`` int32 tokens, at least ``ngram`` a row."""
        tokens = torch.atleast_2d(self._tensor(tokens).to(torch.int32))
        if tokens.shape[-1] < self.ngram:
            raise ValueError(
                f"DistinctNGrams(ngram={self.ngram}) needs sequences of at least {self.ngram} "
                f"tokens, got shape {tuple(tokens.shape)}"
            )
        return tokens

    def _windows(self, tokens: Any) -> Tuple[Tensor, Tensor]:
        """``(rows, n)`` stacked n-gram windows and the ``(rows,)`` validity mask."""
        return ngram_windows(self._tokens(tokens), self.ngram, self.ignore_index)

    def _update(self, state: State, preds: Any) -> State:
        if self._hll is not None:
            tokens = self._tokens(preds)
            tokens = tokens.reshape(-1, tokens.shape[-1]).contiguous()
            insert = _hll_insert_plain if tokens.device.type == "cpu" else hll_insert
            registers, total = insert(state["registers"], state["total"], tokens, self.ngram, self.ignore_index,
                                      self._hll)
            return {"registers": registers, "total": total}
        win, valid = self._windows(preds)
        win = torch.where(valid[:, None], win, _SENTINEL)
        return {"ngrams": tuple(state["ngrams"]) + (win,), "total": state["total"] + valid.sum()}

    def _compute(self, state: State) -> Tensor:
        total = torch.clamp_min(state["total"], 1.0)
        if self._hll is not None:
            return torch.clamp(self._hll.estimate(state["registers"]) / total, 0.0, 1.0)
        rows = dim_zero_cat(state["ngrams"])  # (rows, n)
        # lexicographic order: stable sorts from the last column to the first; sentinel rows group together
        order = torch.arange(rows.shape[0], device=rows.device)
        for col in range(rows.shape[1] - 1, -1, -1):
            order = order[torch.argsort(rows[order, col], stable=True)]
        srt = rows[order]
        valid = srt[:, 0] != _SENTINEL
        changed = torch.cat([torch.ones((1,), dtype=torch.bool, device=rows.device), (srt[1:] != srt[:-1]).any(-1)])
        return (changed & valid).sum() / total
