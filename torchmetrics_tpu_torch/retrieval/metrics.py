"""Modular retrieval metrics (counterpart of ``torchmetrics_tpu/retrieval/metrics.py``).

Each class names the measure that ``retrieval_scores`` computes for every
query (one ``retrieval_groups`` launch on the card). The precision-recall
curve, recall at fixed precision and AUROC's ``max_fpr`` work on
``rank_groups``, which on the card is the kernel's ranked layout.

Example::

    >>> import torch
    >>> from torchmetrics_tpu_torch.retrieval import RetrievalNormalizedDCG
    >>> metric = RetrievalNormalizedDCG(device="cpu")
    >>> metric.update(torch.tensor([0.2, 0.3, 0.5, 0.1]), torch.tensor([0, 1, 0, 1]), torch.tensor([0, 0, 0, 1]))
    >>> round(float(metric.compute()), 4)
    0.8155
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.core.metric import State
from torchmetrics_tpu_torch.functional.retrieval.kernels import (
    _check_top_k as _validate_top_k,
    grouped_precision_recall_curve,
    rank_groups,
)
from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric, _retrieval_aggregate
from torchmetrics_tpu_torch.utilities.data import dim_zero_cat


class _TopKRetrieval(RetrievalMetric):
    def __init__(self, top_k: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _validate_top_k(top_k)
        self.top_k = top_k


class RetrievalMAP(_TopKRetrieval):
    """Mean average precision."""

    _measure = "average_precision"


class RetrievalMRR(_TopKRetrieval):
    """Mean reciprocal rank."""

    _measure = "reciprocal_rank"


class RetrievalPrecision(_TopKRetrieval):
    """Precision@k."""

    _measure = "precision"

    def __init__(self, top_k: Optional[int] = None, adaptive_k: bool = False, **kwargs: Any) -> None:
        super().__init__(top_k=top_k, **kwargs)
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.adaptive_k = adaptive_k

    def _measure_kwargs(self) -> Dict[str, Any]:
        return {"top_k": self.top_k, "adaptive_k": self.adaptive_k}


class RetrievalRecall(_TopKRetrieval):
    """Recall@k."""

    _measure = "recall"


class RetrievalHitRate(_TopKRetrieval):
    """HitRate@k."""

    _measure = "hit_rate"


class RetrievalFallOut(_TopKRetrieval):
    """FallOut@k; lower is better; the empty queries are those with no negative target."""

    higher_is_better = False
    _measure = "fall_out"

    def _empty_mask(self, n_rel: Tensor, sizes: Tensor) -> Tensor:
        return (sizes - n_rel) == 0


class RetrievalRPrecision(RetrievalMetric):
    """R-precision."""

    _measure = "r_precision"


class RetrievalNormalizedDCG(_TopKRetrieval):
    """NDCG@k; takes graded (non-binary) relevance."""

    allow_non_binary_target = True
    _measure = "ndcg"


class RetrievalAUROC(_TopKRetrieval):
    """Per-query AUROC over the retrieved documents; ``max_fpr`` takes each query's
    top-k through the classification ``binary_auroc``, as the JAX class does."""

    _measure = "auroc"

    def __init__(self, top_k: Optional[int] = None, max_fpr: Optional[float] = None, **kwargs: Any) -> None:
        super().__init__(top_k=top_k, **kwargs)
        if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
            raise ValueError(f"Argument `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")
        self.max_fpr = max_fpr

    def _grouped(self, state: State) -> Tuple[Tensor, Tensor]:
        if self.max_fpr is None:
            return super()._grouped(state)
        from torchmetrics_tpu_torch.functional.classification.auroc import binary_auroc

        preds, target, indexes = (dim_zero_cat(state[k]) for k in ("preds", "target", "indexes"))
        rg = rank_groups(preds, target, indexes)
        bounds = torch.cumsum(rg.sizes, 0).to(torch.int64).tolist()  # the groups' runs of the ranked layout
        vals = []
        for g in range(rg.num_groups):
            lo, hi = (bounds[g - 1] if g else 0), bounds[g]
            if self.top_k is not None:
                hi = min(hi, lo + self.top_k)
            pg, tg = rg.preds[lo:hi], rg.target[lo:hi]
            positives = float(tg.sum())
            if positives == 0 or positives == tg.shape[0]:
                vals.append(torch.zeros((), device=preds.device))
            else:
                vals.append(binary_auroc(pg, tg.to(torch.int32), max_fpr=self.max_fpr))
        # no group (every row ignored): no score, as the JAX class's `jnp.asarray([])`, beside its mask of
        # one empty group; `neg` and `pos` then give the mean of nothing, NaN
        scores = torch.stack(vals).to(torch.float32) if vals else torch.zeros((0,), device=preds.device)
        return scores, rg.n_rel == 0


class RetrievalPrecisionRecallCurve(RetrievalMetric):
    """Averaged precision / recall at k = 1..max_k across queries."""

    def __init__(self, max_k: Optional[int] = None, adaptive_k: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if max_k is not None and not (isinstance(max_k, int) and max_k > 0):
            raise ValueError("`max_k` has to be a positive integer or None")
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.max_k = max_k
        self.adaptive_k = adaptive_k

    def _compute(self, state: State) -> Tuple[Tensor, Tensor, Tensor]:
        if not state["preds"]:
            k = self.max_k or 1
            zeros = torch.zeros((k,), device=self.device)
            return zeros, zeros.clone(), torch.arange(1, k + 1, dtype=torch.int32, device=self.device)
        preds, target, indexes = (dim_zero_cat(state[k]) for k in ("preds", "target", "indexes"))
        rg = rank_groups(preds, target, indexes)
        max_k = self.max_k if self.max_k is not None else int(rg.sizes.max())
        prec, rec, topk = grouped_precision_recall_curve(rg, max_k, self.adaptive_k)
        empty = rg.n_rel == 0
        if self.empty_target_action == "error" and bool(empty.any()):
            raise ValueError("`compute` method was provided with a query with no positive target.")
        if self.empty_target_action == "skip":
            prec, rec = prec[~empty], rec[~empty]
        else:
            fill = 1.0 if self.empty_target_action == "pos" else 0.0
            prec = torch.where(empty[:, None], fill, prec)
            rec = torch.where(empty[:, None], fill, rec)
        if prec.shape[0] == 0:
            return torch.zeros((max_k,), device=prec.device), torch.zeros((max_k,), device=prec.device), topk
        return (
            _retrieval_aggregate(prec, self.aggregation, axis=0),
            _retrieval_aggregate(rec, self.aggregation, axis=0),
            topk,
        )


class RetrievalRecallAtFixedPrecision(RetrievalPrecisionRecallCurve):
    """The largest recall whose precision is at least ``min_precision``, and the k that reaches it."""

    def __init__(self, min_precision: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(min_precision, float) and 0.0 <= min_precision <= 1.0):
            raise ValueError("`min_precision` has to be a float between 0 and 1")
        self.min_precision = min_precision

    def _compute(self, state: State) -> Tuple[Tensor, Tensor]:
        precision, recall, top_k = super()._compute(state)
        p, r, k = (x.cpu().numpy() for x in (precision, recall, top_k))
        ok = p >= self.min_precision
        if not ok.any():
            return (torch.zeros((), device=precision.device),
                    torch.tensor(int(k[-1]) if k.size else 0, dtype=torch.int32, device=precision.device))
        best_r, best_k = sorted(zip(r[ok].tolist(), k[ok].tolist()))[-1]
        return (torch.tensor(best_r, dtype=torch.float32, device=precision.device),
                torch.tensor(int(best_k), dtype=torch.int32, device=precision.device))

