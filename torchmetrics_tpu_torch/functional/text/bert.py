"""BERTScore (counterpart of ``torchmetrics_tpu/functional/text/bert.py``).

Greedy token matching over contextual-embedding cosine similarity. The
embedding model is pluggable: any ``(input_ids, attention_mask) -> (B, T, H)``
callable (a torch HuggingFace model, or a custom encoder), or a local
checkpoint directory loaded with the torch ``AutoModel``; nothing is
downloaded. Tokenization is host Python and numpy, copied from the JAX
package; tokenized ids, not strings, are what the class accumulates.

The similarity and matching core (:func:`_bert_score_from_embeddings`) is one
launch of the ``bert_greedy_match`` CUDA kernel on the card
(``kernels/bert_match.py``); the CPU takes its plain version, JAX's form.

Example::

    >>> from torchmetrics_tpu_torch.functional.text.bert import bert_score
    >>> score = bert_score(['the cat sat'], ['the cat sat'], device="cpu")
    >>> round(float(score['f1'][0]), 4)  # identical pair -> 1 under any embedder
    1.0
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels.bert_match import _bert_greedy_match_plain, bert_greedy_match
from torchmetrics_tpu_torch.utilities.data import resolve_device


class WhitespaceTokenizer:
    """Minimal host tokenizer building a vocab on the fly (test/fallback path).

    Real use plugs an HF tokenizer via ``user_tokenizer``.
    """

    def __init__(self, max_length: int = 128) -> None:
        self.vocab: Dict[str, int] = {"<pad>": 0, "<unk>": 1}
        self.max_length = max_length

    def __call__(self, texts: Sequence[str]) -> Dict[str, np.ndarray]:
        ids = []
        for text in texts:
            toks = text.lower().split()[: self.max_length]
            row = []
            for t in toks:
                if t not in self.vocab:
                    self.vocab[t] = len(self.vocab)
                row.append(self.vocab[t])
            ids.append(row)
        max_len = max((len(r) for r in ids), default=1) or 1
        input_ids = np.zeros((len(texts), max_len), dtype=np.int32)
        attention_mask = np.zeros((len(texts), max_len), dtype=np.int32)
        for i, row in enumerate(ids):
            input_ids[i, : len(row)] = row
            attention_mask[i, : len(row)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}


def _compute_idf(input_ids: np.ndarray, attention_mask: np.ndarray) -> Dict[int, float]:
    """Inverse-document-frequency weights over the target corpus."""
    n_docs = input_ids.shape[0]
    df: Counter = Counter()
    for row, mask in zip(input_ids, attention_mask):
        df.update(set(int(t) for t, m in zip(row, mask) if m))
    return {tok: float(np.log((n_docs + 1) / (cnt + 1))) for tok, cnt in df.items()}


def _idf_weights(input_ids: np.ndarray, attention_mask: np.ndarray, idf: Dict[int, float]) -> np.ndarray:
    w = np.zeros(input_ids.shape, dtype=np.float32)
    for i in range(input_ids.shape[0]):
        for j in range(input_ids.shape[1]):
            if attention_mask[i, j]:
                w[i, j] = idf.get(int(input_ids[i, j]), float(np.log((input_ids.shape[0] + 1) / 1)))
    return w


def _process_special_tokens_mask(attention_mask: np.ndarray) -> np.ndarray:
    """Zero the [CLS] (first) and [SEP] (last attended) positions.

    Numpy, as in the JAX package.
    """
    am = np.asarray(attention_mask).astype(np.float32).copy()
    am[:, 0] = 0
    sep_pos = np.cumsum(am - 0.1, axis=-1).argmax(-1)
    am[np.arange(am.shape[0]), sep_pos] = 0
    return am.astype(attention_mask.dtype)


def load_hf_embedder(
    model_name_or_path: str,
    num_layers: Optional[int] = None,
    max_length: int = 512,
    truncation: bool = True,
) -> Tuple[Callable, Callable]:
    """(embed_fn, tokenizer_fn) from a local HuggingFace checkpoint: ``transformers.AutoTokenizer`` and the torch
    ``AutoModel``, whose ``hidden_states[num_layers or -1]`` are the embeddings, run under ``torch.no_grad`` on
    the device of the ids. ``model_name_or_path`` must be a local directory or in the local cache: nothing is
    downloaded (:func:`~torchmetrics_tpu_torch.utilities.imports.hf_local_kwargs`)."""
    from transformers import AutoModel, AutoTokenizer

    from torchmetrics_tpu_torch.utilities.imports import hf_local_kwargs

    kwargs = hf_local_kwargs()
    tok = AutoTokenizer.from_pretrained(model_name_or_path, **kwargs)
    hf_model = AutoModel.from_pretrained(model_name_or_path, **kwargs).eval()

    def embed_fn(input_ids: Tensor, attention_mask: Tensor) -> Tensor:
        hf_model.to(input_ids.device)
        with torch.no_grad():
            out = hf_model(input_ids=input_ids.long(), attention_mask=attention_mask.long(), output_hidden_states=True)
        return out.hidden_states[num_layers if num_layers is not None else -1]

    def tokenizer_fn(texts):
        enc = tok(list(texts), padding=True, truncation=truncation, max_length=max_length, return_tensors="np")
        if not truncation and enc["input_ids"].shape[-1] > max_length:
            raise ValueError(
                f"Tokenized input length {enc['input_ids'].shape[-1]} exceeds "
                f"max_length={max_length} and `truncation=False`. Enable `truncation` "
                "or raise `max_length`."
            )
        return {"input_ids": enc["input_ids"], "attention_mask": enc["attention_mask"]}

    return embed_fn, tokenizer_fn


_DEFAULT_MODEL = "roberta-large"  # the default of torchmetrics' BERTScore
_HF_EMBEDDERS: dict = {}  # (path, layers, max_len, trunc) -> (embed_fn, tokenizer)


def _reject_unsupported_bert_args(all_layers: bool, rescale_with_baseline: bool) -> None:
    """Options that would silently change scores if ignored refuse loudly instead."""
    if all_layers:
        raise NotImplementedError(
            "`all_layers=True` is not supported: the reference aggregates every hidden "
            "layer's embeddings, so ignoring the flag would silently produce different "
            "scores. Select a layer with `num_layers` instead."
        )
    if rescale_with_baseline:
        raise NotImplementedError(
            "`rescale_with_baseline=True` is not supported: baseline files cannot be "
            "fetched in this environment, and ignoring the flag would silently return "
            "un-rescaled scores."
        )


def resolve_embedder(
    model_name_or_path: Optional[str] = None,
    num_layers: Optional[int] = None,
    max_length: int = 512,
    truncation: bool = False,
    model: Optional[Callable] = None,
    user_tokenizer: Optional[Any] = None,
    user_forward_fn: Optional[Callable] = None,
) -> Tuple[Callable, Callable, bool, Optional[str]]:
    """Resolve ``(embed_fn, tokenizer, zero_special_tokens, resolved_name)``.

    Explicit user hooks win; an unspecified ``model_name_or_path`` warns and
    defaults to the recommended model; a named checkpoint loads through
    :func:`load_hf_embedder`. Only the *implicit default* may degrade to the
    deterministic hash embedder, and only when it is absent locally, with a
    loud warning. Any checkpoint the user named must load or raise.
    """

    from torchmetrics_tpu_torch.utilities.prints import rank_zero_warn

    if model is not None or user_forward_fn is not None or user_tokenizer is not None:
        tokenizer = user_tokenizer if user_tokenizer is not None else WhitespaceTokenizer(max_length)
        return user_forward_fn or model or _hash_embedding_model, tokenizer, False, model_name_or_path

    explicit = model_name_or_path is not None
    if not explicit:
        rank_zero_warn(
            "The argument `model_name_or_path` was not specified while it is required when"
            " the default `transformers` model is used."
            f" It will use the default recommended model - {_DEFAULT_MODEL!r}.",
            UserWarning,
        )
        model_name_or_path = _DEFAULT_MODEL

    cache_key = (model_name_or_path, num_layers, max_length, truncation)
    try:
        if cache_key not in _HF_EMBEDDERS:
            _HF_EMBEDDERS[cache_key] = load_hf_embedder(
                model_name_or_path, num_layers, max_length, truncation=truncation
            )
        embed_fn, tokenizer = _HF_EMBEDDERS[cache_key]
        return embed_fn, tokenizer, True, model_name_or_path
    except OSError:
        # Not-found class of failure only; any other error propagates.
        if explicit:
            # a checkpoint the USER named must load or fail loudly,
            # whether it's a local path or a hub id
            raise
        rank_zero_warn(
            f"The default BERT checkpoint {_DEFAULT_MODEL!r} is not available locally (no"
            " download is possible in this environment). Falling back to a deterministic"
            " hash-embedding model — scores will NOT match real BERTScore. Pass a local"
            " checkpoint directory as `model_name_or_path`, or explicit"
            " `model`/`user_forward_fn`, for real scores.",
            UserWarning,
        )
        return _hash_embedding_model, WhitespaceTokenizer(max_length), False, model_name_or_path


def _bert_score_from_embeddings(
    pred_emb: Tensor,
    pred_mask: Tensor,
    target_emb: Tensor,
    target_mask: Tensor,
    pred_weights: Optional[Tensor] = None,
    target_weights: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Greedy-matching P/R/F1 of each pair, float32: one ``bert_greedy_match`` launch on the card, its plain
    version elsewhere.

    pred_emb: (B, Tp, H); target_emb: (B, Tt, H); masks are 0/1.
    """
    f32 = torch.float32
    pred_emb, target_emb = pred_emb.to(f32), target_emb.to(f32)
    pred_mask, target_mask = pred_mask.to(f32), target_mask.to(f32)
    if pred_emb.device.type == "cuda":
        weights = [None if w is None else w.to(f32).contiguous() for w in (pred_weights, target_weights)]
        return bert_greedy_match(pred_emb.contiguous(), pred_mask.contiguous(), target_emb.contiguous(),
                                 target_mask.contiguous(), *weights)
    return _bert_greedy_match_plain(pred_emb, pred_mask, target_emb, target_mask, pred_weights, target_weights)


def _pad_to(x: np.ndarray, length: int) -> np.ndarray:
    return np.pad(x, ((0, 0), (0, length - x.shape[1])))


def _score_ids(
    embed_fn: Callable,
    zero_special: bool,
    idf: bool,
    pred_ids: np.ndarray,
    pred_mask: np.ndarray,
    tgt_ids: np.ndarray,
    tgt_mask: np.ndarray,
    device: torch.device,
) -> Tuple[Tensor, Tensor, Tensor]:
    """P/R/F1 of tokenized pairs: both sides padded to one length, embedded on ``device``, the special tokens'
    positions left out of the scoring where the checkpoint has them, idf weights from the target corpus."""
    t_max = max(pred_ids.shape[1], tgt_ids.shape[1])
    pred_ids, pred_mask, tgt_ids, tgt_mask = (_pad_to(x, t_max) for x in (pred_ids, pred_mask, tgt_ids, tgt_mask))

    def embed(ids, mask):
        return embed_fn(torch.as_tensor(ids, device=device), torch.as_tensor(mask, device=device)).to(device)

    pred_emb = embed(pred_ids, pred_mask)
    tgt_emb = embed(tgt_ids, tgt_mask)

    # the model sees the raw mask; scoring leaves out [CLS]/[SEP]
    score_pred_mask = _process_special_tokens_mask(pred_mask) if zero_special else pred_mask
    score_tgt_mask = _process_special_tokens_mask(tgt_mask) if zero_special else tgt_mask

    pw = tw = None
    if idf:
        idf_map = _compute_idf(tgt_ids, score_tgt_mask)
        pw = torch.as_tensor(_idf_weights(pred_ids, score_pred_mask, idf_map), device=device)
        tw = torch.as_tensor(_idf_weights(tgt_ids, score_tgt_mask, idf_map), device=device)
    return _bert_score_from_embeddings(pred_emb, torch.as_tensor(score_pred_mask, device=device), tgt_emb,
                                       torch.as_tensor(score_tgt_mask, device=device), pw, tw)


def bert_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    model_name_or_path: Optional[str] = None,
    num_layers: Optional[int] = None,
    all_layers: bool = False,
    model: Optional[Callable] = None,
    user_tokenizer: Optional[Any] = None,
    user_forward_fn: Optional[Callable] = None,
    verbose: bool = False,
    idf: bool = False,
    device: Optional[Any] = None,
    max_length: int = 512,
    batch_size: int = 64,
    num_threads: int = 0,
    return_hash: bool = False,
    lang: str = "en",
    rescale_with_baseline: bool = False,
    baseline_path: Optional[str] = None,
    baseline_url: Optional[str] = None,
    truncation: bool = False,
) -> Dict[str, Tensor]:
    """BERTScore P/R/F1 of each sentence pair, on ``device`` (the current CUDA device by default).

    ``model`` (or ``user_forward_fn``) maps (input_ids, attention_mask) to
    (B, T, H) embeddings. Without a model or a local checkpoint, a
    deterministic hash-embedding encoder is used, with a warning.
    """
    _reject_unsupported_bert_args(all_layers, rescale_with_baseline)
    preds_l = [preds] if isinstance(preds, str) else list(preds)
    target_l = [target] if isinstance(target, str) else list(target)
    if len(preds_l) != len(target_l):
        raise ValueError("Number of predicted and reference sententes must be the same!")
    device = resolve_device(device)

    embed_fn, tokenizer, zero_special, model_name_or_path = resolve_embedder(
        model_name_or_path, num_layers, max_length, truncation=truncation,
        model=model, user_tokenizer=user_tokenizer, user_forward_fn=user_forward_fn,
    )
    pred_tok = tokenizer(preds_l)
    tgt_tok = tokenizer(target_l)
    precision, recall, f1 = _score_ids(
        embed_fn, zero_special, idf,
        np.asarray(pred_tok["input_ids"]), np.asarray(pred_tok["attention_mask"]),
        np.asarray(tgt_tok["input_ids"]), np.asarray(tgt_tok["attention_mask"]), device,
    )
    out = {"precision": precision, "recall": recall, "f1": f1}
    if return_hash:
        out["hash"] = f"tpu_bert_score(model={model_name_or_path or 'hash-embedding'})"  # type: ignore[assignment]
    return out


_MASK32 = 0xFFFFFFFF


def _mul32(a: Tensor, b: int) -> Tensor:
    """``a * b`` modulo 2**32 for int64 ``a`` in [0, 2**32) and ``b`` < 2**32, with no int64 overflow: the
    product split at 16 bits of ``a``."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _MASK32


def _hash_embedding_model(input_ids: Tensor, attention_mask: Tensor, dim: int = 128) -> Tensor:
    """Deterministic token-hash embeddings, the hermetic fallback encoder: JAX's uint32 arithmetic with
    wraparound, in int64 masked to 32 bits (torch's uint32 lacks the operations), bit for bit."""
    ids = torch.as_tensor(input_ids).to(torch.int64) & _MASK32
    ar = torch.arange(dim, dtype=torch.int64, device=ids.device)
    x = (_mul32(ids[..., None], 2654435761) + ar * 40503) & _MASK32
    x ^= x >> 16
    x = _mul32(x, 2246822519)
    x ^= x >> 13
    vals = (x % 10007).to(torch.float32) / 10007.0 - 0.5
    return vals * torch.as_tensor(attention_mask, device=ids.device)[..., None]
