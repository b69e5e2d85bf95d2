"""Launcher of the ``perplexity_nll`` CUDA kernel (``csrc/perplexity.cu``) and its plain version.

:func:`perplexity_nll` takes ``(N, V)`` logits (float32, bfloat16 or float16)
and ``(N,)`` int32 or int64 targets and gives the float32 summed negative
log-likelihood of the targets and the float32 count of rows not ignored, in
one launch: an online maximum and sum of exponentials over each row, read
once, and a fixed-order sum in the last block. It counts its launches in
``perplexity_nll.launches`` and takes CUDA tensors only. It is a
``torch.autograd.Function``: its backward, ``grad * (exp(x - lse) -
onehot(target)) * mask`` from the rows' saved log-sum-exp, is plain PyTorch.
An input that requires grad takes the kernel all the same.

:func:`_perplexity_nll_plain` is the JAX package's form in plain PyTorch: a
float32 ``log_softmax``, the gather of the targets and the masked sums. The
dispatch by device is ``functional.text.perplexity._perplexity_update``.

The semantics held are JAX's: an ignored row adds nothing, whatever its
logits; a target in ``[-V, 0)`` wraps once; one outside ``[-V, V)`` makes the
total NaN (``take_along_axis``'s fill); an empty batch gives ``(-0., 0.)``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import launch_on, load_library, zero_tickets

SOURCE = "perplexity"
THREADS = 256  # kBlockThreads
WARP_ROW_MAX = 4096  # kWarpRowMax: a warp a row up to this vocabulary, a block a row above it
UNROLL = 4  # kUnroll: 16-byte vectors in flight a thread
MAX_ROWS = 2**31 - 1  # rows along grid.x (a block a row)

# the codes of csrc/perplexity.cu
KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
TARGET_KINDS = {torch.int32: 0, torch.int64: 1}

_launch: Optional[ctypes._CFuncPtr] = None


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).perplexity_nll_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, ll, ll, p, i, i, ll, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def plan(vocab: int) -> int:
    """The threads that scan a row: a warp up to ``WARP_ROW_MAX``, a block of ``THREADS`` above it."""
    return 32 if vocab <= WARP_ROW_MAX else THREADS


def _picked_and_mask(logits: Tensor, target: Tensor, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor, Tensor]:
    """The wrapped targets ``(N,)``, whether each lies in ``[0, V)``, and the rows kept (not ``ignore_index``)."""
    v = logits.shape[-1]
    mask = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    safe = torch.where(mask, target, torch.zeros_like(target)).to(torch.int64)
    wrapped = torch.where(safe < 0, safe + v, safe)
    return wrapped, (wrapped >= 0) & (wrapped < v), mask


def _perplexity_nll_plain(logits: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch :func:`perplexity_nll`: JAX's float32 ``log_softmax``, gather and masked sums."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    wrapped, in_range, mask = _picked_and_mask(logits, target, ignore_index)
    picked = logp.gather(1, wrapped.clamp(0, max(logits.shape[-1] - 1, 0))[:, None])[:, 0]
    picked = torch.where(in_range, picked, torch.nan)
    total = -torch.where(mask, picked, torch.zeros_like(picked)).sum()
    return total, mask.sum().to(torch.float32)


def _launch_nll(logits: Tensor, target: Tensor, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor, Tensor]:
    """One launch: ``(total, count, lse)``, the rows' log-sum-exp ``(N,)`` for the backward."""
    device = logits.device
    n_rows, v = logits.shape
    total = torch.empty((), dtype=torch.float32, device=device)
    count = torch.empty((), dtype=torch.float32, device=device)
    row_nll = torch.empty((n_rows,), dtype=torch.float32, device=device)
    lse = torch.empty((n_rows,), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    has_ignore = ignore_index is not None
    args = (logits.data_ptr(), KINDS[logits.dtype], n_rows, v, target.data_ptr(), TARGET_KINDS[target.dtype],
            int(has_ignore), int(ignore_index) if has_ignore else 0, row_nll.data_ptr(), lse.data_ptr(),
            total.data_ptr(), count.data_ptr(), zero_tickets(device, stream, 1).data_ptr(), stream)
    launch_on("perplexity_nll", device, _launch_fn(), args)
    perplexity_nll.launches += 1
    return total, count, lse


def _nll_grad(logits: Tensor, target: Tensor, ignore_index: Optional[int], lse: Tensor, grad_total: Tensor) -> Tensor:
    """The gradient of the total for ``logits``: ``grad_total * (exp(x - lse) - onehot(target))`` on the kept rows
    with a target in range, 0 elsewhere, in the logits' dtype."""
    wrapped, in_range, mask = _picked_and_mask(logits, target, ignore_index)
    grad = torch.exp(logits.to(torch.float32) - lse[:, None])
    grad.scatter_add_(1, wrapped.clamp(0, logits.shape[-1] - 1)[:, None], -torch.ones_like(lse)[:, None])
    # a where, not a product: an ignored row's exponentials (lse 0 there) may be inf or NaN
    return torch.where((mask & in_range)[:, None], grad * grad_total, 0.0).to(logits.dtype)


class _PerplexityNLL(torch.autograd.Function):
    """The kernel forward; the backward ``grad * (softmax - onehot) * mask`` in plain PyTorch."""

    @staticmethod
    def forward(ctx, logits: Tensor, target: Tensor, ignore_index: Optional[int]):  # type: ignore[override]
        total, count, lse = _launch_nll(logits, target, ignore_index)
        ctx.save_for_backward(logits, target, lse)
        ctx.ignore_index = ignore_index
        ctx.mark_non_differentiable(count)
        return total, count

    @staticmethod
    def backward(ctx, grad_total: Tensor, grad_count: Tensor):  # type: ignore[override]
        logits, target, lse = ctx.saved_tensors
        return _nll_grad(logits, target, ctx.ignore_index, lse, grad_total), None, None


def perplexity_nll(logits: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """The float32 summed NLL of the targets and the float32 count of kept rows, by the CUDA kernel.

    ``chip_smoke.py`` holds it against :func:`_perplexity_nll_plain` on the
    card (1e-5 relative on the total, the count exactly), and its backward
    against autograd of the plain version.

    Args:
        logits: ``(N, V)`` float32, bfloat16 or float16, contiguous, on a
            CUDA device; V at least 1.
        target: ``(N,)`` int32 or int64, contiguous, on the same device.
        ignore_index: the target value of rows to leave out, or None.

    Every check raises ``ValueError`` before anything is built or launched; a
    CUDA error of the launch raises ``RuntimeError``. An empty batch launches
    nothing and gives ``(-0., 0.)``.
    """
    if logits.dtype not in KINDS:
        raise ValueError(f"perplexity_nll takes float32, bfloat16 or float16 logits, got {logits.dtype}")
    if target.dtype not in TARGET_KINDS:
        raise ValueError(f"perplexity_nll takes int32 or int64 targets, got {target.dtype}")
    if logits.ndim != 2 or target.shape != logits.shape[:1] or logits.shape[1] < 1:
        raise ValueError(f"perplexity_nll takes (N, V) logits with V >= 1 and (N,) targets, got "
                         f"{tuple(logits.shape)} and {tuple(target.shape)}")
    if not logits.is_contiguous() or not target.is_contiguous():
        raise ValueError("perplexity_nll: `logits` and `target` must be contiguous")
    device = logits.device
    if target.device != device:
        raise ValueError(f"perplexity_nll: `target` is on {target.device}, expected {device}")
    if device.type != "cuda":
        raise ValueError(f"perplexity_nll runs on CUDA tensors only, got them on {device}")
    n_rows = logits.shape[0]
    if n_rows > MAX_ROWS:
        raise ValueError(f"perplexity_nll takes at most {MAX_ROWS} rows, got {n_rows}")
    if n_rows == 0:
        return torch.tensor(-0.0, device=device), torch.tensor(0.0, device=device)
    return _PerplexityNLL.apply(logits, target, ignore_index)


perplexity_nll.launches = 0
