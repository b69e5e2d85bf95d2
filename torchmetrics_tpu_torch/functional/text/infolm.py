"""InfoLM (counterpart of ``torchmetrics_tpu/functional/text/infolm.py``).

Information measures between per-sentence token distributions produced by a
masked language model: a local HuggingFace checkpoint loaded with the torch
``AutoModelForMaskedLM`` (each position masked in turn, as torchmetrics does;
nothing is downloaded), or any ``(input_ids, attention_mask) -> (B, T, V)``
logits or probability callable. The nine measures, the distributions and
their aggregation are torch operations on the model's device.

Example::

    >>> from torchmetrics_tpu_torch.functional.text.infolm import infolm
    >>> preds = ['the cat sat on the mat']
    >>> target = ['the cat sat on the mat']
    >>> round(float(infolm(preds, target, information_measure='l2_distance', idf=False, verbose=False,
    ...                    device="cpu")), 4)
    0.0
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.bert import (
    WhitespaceTokenizer,
    _compute_idf,
    _hash_embedding_model,
    _idf_weights,
)
from torchmetrics_tpu_torch.utilities.data import resolve_device
from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

_ALLOWED_INFORMATION_MEASURE = (
    "kl_divergence",
    "alpha_divergence",
    "beta_divergence",
    "ab_divergence",
    "renyi_divergence",
    "l1_distance",
    "l2_distance",
    "l_infinity_distance",
    "fisher_rao_distance",
)


# which hyper-parameters each parameterized measure needs ...
_REQUIRED_PARAMS: Dict[str, Tuple[str, ...]] = {
    "alpha_divergence": ("alpha",),
    "beta_divergence": ("beta",),
    "ab_divergence": ("alpha", "beta"),
    "renyi_divergence": ("alpha",),
}
# ... and the parameter values where its closed form divides by zero
_SINGULAR_PARAMS: Dict[str, Callable[[Optional[float], Optional[float]], bool]] = {
    "alpha_divergence": lambda a, b: a in (0.0, 1.0),
    "beta_divergence": lambda a, b: b in (0.0, -1.0),
    "ab_divergence": lambda a, b: 0.0 in (a, b, a + b),
    "renyi_divergence": lambda a, b: a == 1.0,
}


class _InformationMeasure:
    """Measure dispatch and parameter validation."""

    def __init__(
        self,
        information_measure: str = "kl_divergence",
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
    ) -> None:
        if information_measure not in _ALLOWED_INFORMATION_MEASURE:
            raise ValueError(
                f"Unknown `information_measure` {information_measure!r}; choose one of "
                f"{', '.join(_ALLOWED_INFORMATION_MEASURE)}."
            )
        params = {"alpha": alpha, "beta": beta}
        for name in _REQUIRED_PARAMS.get(information_measure, ()):
            if not isinstance(params[name], float):
                raise ValueError(
                    f"`information_measure={information_measure!r}` requires a float `{name}` parameter."
                )
        singular_check = _SINGULAR_PARAMS.get(information_measure)
        if singular_check is not None and singular_check(alpha, beta):
            raise ValueError(
                f"The given parameters make {information_measure!r} degenerate (zero denominator "
                "in its closed form): `alpha` must avoid {0, 1} for the alpha divergence and 1 for "
                "Rényi; `beta` must avoid {0, -1} for the beta divergence; and alpha, beta, "
                "alpha+beta must all be nonzero for the AB divergence."
            )
        self.information_measure = information_measure
        self.alpha = alpha
        self.beta = beta

    def __call__(self, preds_distribution: Tensor, target_distribution: Tensor) -> Tensor:
        return getattr(self, f"_calculate_{self.information_measure}")(
            preds_distribution, target_distribution
        )

    @staticmethod
    def _calculate_kl_divergence(p: Tensor, t: Tensor) -> Tensor:
        return torch.sum(t * torch.log(p / t), dim=-1)

    def _calculate_alpha_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        denom = self.alpha * (self.alpha - 1)
        return (1 - torch.sum(t**self.alpha * p ** (1 - self.alpha), dim=-1)) / denom

    def _calculate_ab_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        a = torch.log(torch.sum(t ** (self.beta + self.alpha), dim=-1)) / (self.beta * (self.beta + self.alpha))
        b = torch.log(torch.sum(p ** (self.beta + self.alpha), dim=-1)) / (self.alpha * (self.beta + self.alpha))
        c = torch.log(torch.sum(t**self.alpha * p**self.beta, dim=-1)) / (self.alpha * self.beta)
        return a + b - c

    def _calculate_beta_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        self.alpha = 1.0
        return self._calculate_ab_divergence(p, t)

    def _calculate_renyi_divergence(self, p: Tensor, t: Tensor) -> Tensor:
        return torch.log(torch.sum(t**self.alpha * p ** (1 - self.alpha), dim=-1)) / (self.alpha - 1)

    @staticmethod
    def _calculate_l1_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.abs(t - p).sum(dim=-1)

    @staticmethod
    def _calculate_l2_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.sqrt(torch.square(t - p).sum(dim=-1))

    @staticmethod
    def _calculate_l_infinity_distance(p: Tensor, t: Tensor) -> Tensor:
        return torch.abs(t - p).amax(dim=-1)

    @staticmethod
    def _calculate_fisher_rao_distance(p: Tensor, t: Tensor) -> Tensor:
        return 2 * torch.arccos(torch.clamp(torch.sqrt(p * t).sum(dim=-1), 0, 1))


def _hash_lm(input_ids: Tensor, attention_mask: Tensor, vocab_size: int = 512) -> Tensor:
    """Deterministic fallback masked-LM distribution (hermetic testing)."""
    emb = _hash_embedding_model(input_ids, attention_mask, dim=vocab_size)
    return torch.softmax(emb * 8.0, dim=-1)


_HF_MLMS: dict = {}
_HF_FAILED: set = set()


def _load_hf_mlm(model_name_or_path: str):
    """Memoized (tokenizer, torch ``AutoModelForMaskedLM``, masked-position function) of a local checkpoint.

    The function ``(input_ids, attention_mask, pos, mask_id, temperature)`` masks position ``pos`` of every row
    and gives the temperature softmax of the model's logits there, ``(B, V)``, under ``torch.no_grad`` on the
    device of the ids.
    """
    if model_name_or_path not in _HF_MLMS:
        from transformers import AutoModelForMaskedLM, AutoTokenizer

        from torchmetrics_tpu_torch.utilities.imports import hf_local_kwargs

        kwargs = hf_local_kwargs()
        tokenizer = AutoTokenizer.from_pretrained(model_name_or_path, **kwargs)
        model = AutoModelForMaskedLM.from_pretrained(model_name_or_path, **kwargs).eval()

        def masked_position_probs(input_ids: Tensor, attention_mask: Tensor, pos: int, mask_id: int,
                                  temperature: float) -> Tensor:
            model.to(input_ids.device)
            masked = input_ids.clone()
            masked[:, pos] = mask_id
            with torch.no_grad():
                logits = model(input_ids=masked, attention_mask=attention_mask).logits
            return torch.softmax(logits[:, pos, :].to(torch.float32) / temperature, dim=-1)

        _HF_MLMS[model_name_or_path] = (tokenizer, model, masked_position_probs)
    return _HF_MLMS[model_name_or_path]


def _corpus_tokens_idf(input_ids: np.ndarray) -> Tuple[Dict[int, float], float]:
    """Sentence-level document frequencies to an idf map, ``log((N+1)/(occurrences+1))``, default ``log(N+1)``."""
    n = len(input_ids)
    counter: Counter = Counter()
    for row in input_ids:
        counter.update(set(row.tolist()))
    idf = {tok: math.log((n + 1) / (occ + 1)) for tok, occ in counter.items()}
    return idf, math.log(n + 1)


def _hf_data_distribution(
    model_name_or_path: str,
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
    temperature: float,
    idf: bool,
    batch_size: int = 64,
    device: Optional[torch.device] = None,
) -> Tensor:
    """Per-sentence discrete distributions ``(N, V)`` by per-position masking.

    Every position is masked in turn, the model's distribution there is
    temperature-softmaxed, weighted by the (own-corpus) idf of the original
    token, the special tokens' positions (pad, sep, cls) are zeroed, and the
    positions are averaged. The corpus goes in ``batch_size`` chunks, each
    reduced over positions at once, so the peak is ``(batch, V)``.
    """
    tokenizer, _, masked_position_probs = _load_hf_mlm(model_name_or_path)
    special = [tokenizer.pad_token_id, tokenizer.sep_token_id, tokenizer.cls_token_id]
    token_mask = ~np.isin(input_ids, [t for t in special if t is not None])

    weights = token_mask.astype(np.float32)
    idf_w = None
    if idf:
        idf_map, default = _corpus_tokens_idf(input_ids)
        idf_w = np.vectorize(lambda t: idf_map.get(int(t), default))(input_ids).astype(np.float32)
        weights = weights * idf_w

    seq_len = input_ids.shape[1]
    chunks = []
    for lo in range(0, len(input_ids), batch_size):
        hi = lo + batch_size
        ids_c = torch.as_tensor(input_ids[lo:hi], device=device)
        mask_c = torch.as_tensor(attention_mask[lo:hi], device=device)
        tm_c = torch.as_tensor(token_mask[lo:hi].astype(np.float32), device=device)
        acc = None
        for s in range(seq_len):
            probs = masked_position_probs(ids_c, mask_c, s, tokenizer.mask_token_id, temperature)
            if idf_w is not None:
                probs = probs * torch.as_tensor(idf_w[lo:hi, s], device=device)[:, None]
            probs = probs * tm_c[:, s][:, None]
            acc = probs if acc is None else acc + probs
        chunks.append(acc / torch.as_tensor(weights[lo:hi].sum(axis=1), device=device)[:, None])
    return torch.cat(chunks, dim=0)


def _sentence_distribution(
    logits_or_probs: Tensor, attention_mask: Tensor, idf_weights: Optional[Tensor] = None
) -> Tensor:
    """Aggregate per-token distributions to one per-sentence distribution."""
    probs = logits_or_probs
    if bool((torch.abs(probs.sum(-1) - 1.0) > 1e-3).any()):
        probs = torch.softmax(probs, dim=-1)
    w = attention_mask.to(torch.float32)
    if idf_weights is not None:
        w = w * idf_weights
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-12)
    return (probs * w[..., None]).sum(dim=1)


def _checkpoint_distributions(resolved, model_name_or_path, preds_l, target_l, temperature, idf, max_length,
                              batch_size, device) -> Tuple[Tensor, Tensor]:
    hf_tokenizer, hf_model, _ = resolved
    # PretrainedConfig's max_length (20) where the config still has one
    eff_max_length = max_length or getattr(hf_model.config, "max_length", None) or 20
    dists = []
    for texts in (preds_l, target_l):
        enc = hf_tokenizer(texts, padding="max_length", max_length=eff_max_length, truncation=True,
                           return_tensors="np")
        dists.append(_hf_data_distribution(model_name_or_path, enc["input_ids"], enc["attention_mask"], temperature,
                                           idf, batch_size, device))
    return dists[0], dists[1]


def _model_distributions(model, user_tokenizer, preds_l, target_l, temperature, idf, max_length,
                         device) -> Tuple[Tensor, Tensor]:
    tokenizer = user_tokenizer if user_tokenizer is not None else WhitespaceTokenizer(max_length or 128)
    lm = model or _hash_lm
    pred_tok = tokenizer(preds_l)
    tgt_tok = tokenizer(target_l)
    p_ids, p_mask = (np.asarray(pred_tok[k]) for k in ("input_ids", "attention_mask"))
    t_ids, t_mask = (np.asarray(tgt_tok[k]) for k in ("input_ids", "attention_mask"))

    p_idf = t_idf = None
    if idf:  # idf-weighted token aggregation over the target corpus
        idf_map = _compute_idf(t_ids, t_mask)
        p_idf = torch.as_tensor(_idf_weights(p_ids, p_mask, idf_map), device=device)
        t_idf = torch.as_tensor(_idf_weights(t_ids, t_mask, idf_map), device=device)

    dists = []
    for ids, mask, weights in ((p_ids, p_mask, p_idf), (t_ids, t_mask, t_idf)):
        ids_t, mask_t = torch.as_tensor(ids, device=device), torch.as_tensor(mask, device=device)
        out = torch.as_tensor(lm(ids_t, mask_t), device=device).to(torch.float32)
        dists.append(_sentence_distribution(out / temperature, mask_t, weights))
    return dists[0], dists[1]


def infolm(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    model_name_or_path: str = "bert-base-uncased",
    temperature: float = 0.25,
    information_measure: str = "kl_divergence",
    idf: bool = True,
    alpha: Optional[float] = None,
    beta: Optional[float] = None,
    device: Optional[Any] = None,
    max_length: Optional[int] = None,
    batch_size: int = 64,
    num_threads: int = 0,
    verbose: bool = True,
    return_sentence_level_score: bool = False,
    model: Optional[Callable] = None,
    user_tokenizer: Optional[Any] = None,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """InfoLM score, float32 on ``device`` (the current CUDA device by default); ``model`` maps
    (input_ids, attention_mask) to (B, T, V) distributions or logits."""
    preds_l = [preds] if isinstance(preds, str) else list(preds)
    target_l = [target] if isinstance(target, str) else list(target)
    if len(preds_l) != len(target_l):
        raise ValueError("Number of predicted and reference sententes must be the same!")
    measure = _InformationMeasure(information_measure, alpha, beta)
    device = resolve_device(device)

    resolved = None
    if model is None and user_tokenizer is None:
        # the checkpoint named, loaded locally; the hash LM only when it is not there, with a warning
        import os

        if os.path.isdir(model_name_or_path):
            resolved = _load_hf_mlm(model_name_or_path)  # an explicit path fails loudly
        elif model_name_or_path not in _HF_FAILED:
            try:
                resolved = _load_hf_mlm(model_name_or_path)
            except (OSError, ValueError, ImportError):
                _HF_FAILED.add(model_name_or_path)
                rank_zero_warn(
                    f"InfoLM checkpoint {model_name_or_path!r} is not available locally (nothing is downloaded). "
                    "Falling back to the deterministic hash LM: scores will NOT match the reference. Pass a local "
                    "checkpoint directory, or an explicit `model` callable, for real scores.",
                    UserWarning,
                )
    if resolved is not None:
        p_dist, t_dist = _checkpoint_distributions(resolved, model_name_or_path, preds_l, target_l, temperature, idf,
                                                   max_length, batch_size, device)
    else:
        p_dist, t_dist = _model_distributions(model, user_tokenizer, preds_l, target_l, temperature, idf, max_length,
                                              device)
    # floor to keep the log and ratio measures finite
    per_sentence = measure(torch.clamp_min(p_dist, 1e-12), torch.clamp_min(t_dist, 1e-12))
    score = per_sentence.mean()
    return (score, per_sentence) if return_sentence_level_score else score
