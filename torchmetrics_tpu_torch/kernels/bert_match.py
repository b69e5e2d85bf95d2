"""Launcher of the ``bert_greedy_match`` CUDA kernel (``csrc/bert_match.cu``) and its plain version.

:func:`bert_greedy_match` takes BERTScore's prediction and target embeddings
``(B, Tp, H)`` and ``(B, Tt, H)``, their masks and optional idf weights, and
gives each pair's precision, recall and F1 ``(B,)``, in one launch: a block a
pair lists each side's tokens with a mask above 0, streams their rows through
shared memory in chunks of H once (below 129 of them a side), takes the
cosine similarities on the tensor cores in three TF32 passes (each operand
split into a TF32 high part and the TF32 rest) and folds them into row and
column maxima in registers, never writing them. It counts its launches in
``bert_greedy_match.launches`` and takes CUDA tensors only.
:func:`_bert_greedy_match_plain` is the JAX package's
``_bert_score_from_embeddings`` in plain PyTorch: the normalised rows, the
``(B, Tp, Tt)`` similarity, the masked maxima and the weighted means. The
dispatch by device is ``functional.text.bert._bert_score_from_embeddings``.

The rules kept are JAX's: an invalid entry (a masked token on either side)
counts as similarity 0 in both maxima, over the whole padded axis, so a row
whose valid similarities are all negative floors at 0 only where its axis has
an invalid entry; a NaN among a row's or column's entries makes its maximum
NaN (a NaN or +-inf in a valid embedding row gives NaN in P, R and F1), one in
a masked row changes nothing.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import check_tensor, launch_on, load_library

SOURCE = "bert_match"
BLOCK = 128  # kBlock: listed tokens a side a pass
CHUNK = 16  # kChunk: H a stage
STAGES = 4  # kStages
THREADS = 256  # kThreads
MAX_TOKENS = 16_384  # Tp + Tt: their maxima and list entries, 6 bytes a token, beside the stages in shared memory
MAX_PAIRS = 2**31 - 1  # pairs along grid.x

_launch: Optional[ctypes._CFuncPtr] = None


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).bert_match_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _bert_greedy_match_plain(
    pred_emb: Tensor,
    pred_mask: Tensor,
    target_emb: Tensor,
    target_mask: Tensor,
    pred_weights: Optional[Tensor] = None,
    target_weights: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch :func:`bert_greedy_match`: JAX's ``_bert_score_from_embeddings``."""
    pred_n = pred_emb / torch.clamp_min(torch.linalg.vector_norm(pred_emb, dim=-1, keepdim=True), 1e-12)
    tgt_n = target_emb / torch.clamp_min(torch.linalg.vector_norm(target_emb, dim=-1, keepdim=True), 1e-12)
    sim = torch.einsum("bph,bth->bpt", pred_n, tgt_n)
    valid = pred_mask[:, :, None] * target_mask[:, None, :]
    # masked entries contribute similarity 0, so a max over a masked axis floors at 0
    sim = torch.where(valid > 0, sim, 0.0)

    pm = pred_mask.to(torch.float32)
    tm = target_mask.to(torch.float32)
    pw = pm if pred_weights is None else pred_weights * pm
    tw = tm if target_weights is None else target_weights * tm

    best_for_pred = torch.where(pm > 0, sim.amax(dim=2), 0.0)
    best_for_tgt = torch.where(tm > 0, sim.amax(dim=1), 0.0)
    precision = (best_for_pred * pw).sum(-1) / torch.clamp_min(pw.sum(-1), 1e-12)
    recall = (best_for_tgt * tw).sum(-1) / torch.clamp_min(tw.sum(-1), 1e-12)
    f1 = 2 * precision * recall / torch.clamp_min(precision + recall, 1e-12)
    return precision, recall, f1


def bert_greedy_match(
    pred_emb: Tensor,
    pred_mask: Tensor,
    target_emb: Tensor,
    target_mask: Tensor,
    pred_weights: Optional[Tensor] = None,
    target_weights: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Each pair's precision, recall and F1 ``(B,)`` float32, by the CUDA kernel.

    ``chip_smoke.py`` holds it against :func:`_bert_greedy_match_plain` on the
    card within 1e-5 absolute.

    Args:
        pred_emb, target_emb: float32 ``(B, Tp, H)`` and ``(B, Tt, H)``,
            contiguous, on one CUDA device; Tp, Tt and H at least 1, Tp + Tt
            at most ``MAX_TOKENS``.
        pred_mask, target_mask: float32 ``(B, Tp)`` and ``(B, Tt)``, 1 for a
            token scored, 0 for one not.
        pred_weights, target_weights: float32 idf weights of the masks'
            shapes, or None (the masks weigh).

    Every check raises ``ValueError`` before anything is built or launched; a
    CUDA error of the launch raises ``RuntimeError``. An empty batch launches
    nothing.
    """
    if pred_emb.ndim != 3 or target_emb.ndim != 3 or pred_emb.shape[0] != target_emb.shape[0] \
            or pred_emb.shape[2] != target_emb.shape[2]:
        raise ValueError(f"bert_greedy_match takes (B, Tp, H) and (B, Tt, H) embeddings, got "
                         f"{tuple(pred_emb.shape)} and {tuple(target_emb.shape)}")
    batch, tp, h = pred_emb.shape
    tt = target_emb.shape[1]
    if min(tp, tt, h) < 1 or tp + tt > MAX_TOKENS or batch > MAX_PAIRS:
        raise ValueError(f"bert_greedy_match takes Tp, Tt and H of at least 1, Tp + Tt up to {MAX_TOKENS} and up to "
                         f"{MAX_PAIRS} pairs, got {batch} pairs of Tp = {tp}, Tt = {tt}, H = {h}")
    device = pred_emb.device
    if device.type != "cuda":
        raise ValueError(f"bert_greedy_match runs on CUDA tensors only, got them on {device}")
    f32 = torch.float32
    for name, x, shape in (("pred_emb", pred_emb, (batch, tp, h)), ("target_emb", target_emb, (batch, tt, h)),
                           ("pred_mask", pred_mask, (batch, tp)), ("target_mask", target_mask, (batch, tt))):
        check_tensor("bert_greedy_match", name, x, f32, shape, device)
    for name, x, shape in (("pred_weights", pred_weights, (batch, tp)), ("target_weights", target_weights, (batch, tt))):
        if x is not None:
            check_tensor("bert_greedy_match", name, x, f32, shape, device)
    out = torch.empty((3, batch), dtype=f32, device=device)
    if batch == 0:
        return out[0], out[1], out[2]
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    args = (pred_emb.data_ptr(), target_emb.data_ptr(), pred_mask.data_ptr(), target_mask.data_ptr(),
            ptr(pred_weights), ptr(target_weights), batch, tp, tt, h, out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    launch_on("bert_greedy_match", device, _launch_fn(), args)
    bert_greedy_match.launches += 1
    return out[0], out[1], out[2]


bert_greedy_match.launches = 0
