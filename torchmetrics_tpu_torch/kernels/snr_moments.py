"""Launcher of the ``snr_moments`` CUDA kernel (``csrc/snr_moments.cu``) and its plain version.

:func:`snr_moments` gives the SNR family's values in dB from float32 signals
in one launch: it sums each row's (or each speaker pair's) first and second
moments in float64 and writes the float32 value with JAX's formulas and eps.

- rows mode: ``(R, T)`` rows, one value each (SNR, SI-SDR), or one value a
  group of ``group`` rows (SA-SDR, which sums over the speakers before its
  ratio): ``(R // group,)``;
- pairs mode: ``(B, S, T)`` estimates and targets, the value of every (target
  j, estimate i) pair of an item: ``(B, S, S)`` with ``[b, j, i]``, as the
  tile of speaker-wise PIT lays it out, without the tile.

The expanded noise energy (``a^2 Stt - 2 a Spt + Spp``) is clamped at 0. It
counts its launches in ``snr_moments.launches`` and takes CUDA tensors only.
:func:`_snr_moments_plain` is the JAX package's form in plain PyTorch (the
noise and the squared sums of JAX's ``snr.py`` and ``sdr.py``, PIT's tile in
pairs mode). The dispatch by device, dtype and grad is
``functional.audio.snr._ratio_db``.

:func:`plan` is the launch geometry, kept in Python so that the CPU tests
reach it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.kernels._build import cdiv, launch_on, load_library, sm_count, zero_tickets

SOURCE = "snr_moments"
THREADS = 256  # kThreads
MAX_SPEAKERS = 6  # kMaxSpeakers: S^2 + 4 S double sums a thread in registers
VEC = 4  # samples a 16-byte load; a chunk is a whole number of them
LOADS = 8  # kLoads: 16-byte loads of each row a thread issues at once at one speaker, LOADS // S at S speakers
CLUSTER = 8  # kCluster: blocks a thread-block cluster at most (the portable size)
BLOCKS_PER_SM = 2  # blocks an SM the plan fills the card with (a thread holds its loads in registers)
MAX_CHUNKS = 65_535  # chunks along grid.y
MAX_UNITS = 2**31 - 1  # rows or items along grid.x
EPS = float(torch.finfo(torch.float32).eps)  # kEps: JAX's finfo(float32).eps

_launch: Optional[ctypes._CFuncPtr] = None


class Plan(NamedTuple):
    chunk: int  # positions a block, a multiple of VEC
    chunks: int  # blocks a unit (grid.y)
    cluster_units: int  # a cluster's blocks along the units: the group, or 1
    cluster_chunks: int  # a cluster's blocks along the chunks


def row_loads(speakers: int) -> int:
    """16-byte loads of each of a unit's rows a thread issues before its first multiply-add (``kRowLoads``)."""
    return max(1, LOADS // speakers)


def cluster_shape(chunks: int, group: int) -> tuple:
    """The launcher's cluster (``cluster_shape``): the group's units x its chunks where they fit ``CLUSTER``
    blocks, else one block, merged by the second level."""
    return (group, chunks) if group * chunks <= CLUSTER else (1, 1)


@functools.lru_cache(maxsize=256)
def plan(units: int, length: int, sm_count: int, group: int = 1, speakers: int = 1) -> Plan:
    """Chunks of one batch of each thread's loads (``row_loads``), fewer where that gives more than
    ``BLOCKS_PER_SM`` blocks an SM over all units; a group's chunks one cluster where they fit one (a group of
    ``g`` rows whose chunks outnumber ``CLUSTER / g`` takes that many while that gives every SM a block), else a
    block a cluster, merged by the second level."""
    per_block = THREADS * VEC * row_loads(speakers)
    chunks = max(1, min(cdiv(length, per_block), cdiv(BLOCKS_PER_SM * sm_count, units), MAX_CHUNKS))
    if group * chunks > CLUSTER and group <= CLUSTER and units // group * CLUSTER >= sm_count:
        chunks = CLUSTER // group
    chunk = max(VEC, cdiv(cdiv(length, chunks), VEC) * VEC)
    return Plan(chunk, chunks, *cluster_shape(chunks, group))


def _launch_fn() -> ctypes._CFuncPtr:
    global _launch
    if _launch is None:
        fn = load_library(SOURCE).snr_moments_launch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, ll, ll, ll, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _launch = fn
    return _launch


def _snr_moments_plain(preds: Tensor, target: Tensor, scale_invariant: bool, zero_mean: bool, group: int = 1,
                       pairs: bool = False) -> Tensor:
    """Plain PyTorch :func:`snr_moments`: JAX's formulas (SA-SDR's, which are SNR's and SI-SDR's at one row a
    group) in the inputs' dtype, with eps of ``preds``' dtype; in pairs mode on JAX's speaker-wise tile."""
    if pairs:
        b, s = target.shape[:2]
        p_rep = preds[:, None].expand(b, s, s, *preds.shape[2:]).reshape(b * s * s, *preds.shape[2:])
        t_rep = target[:, :, None].expand(b, s, s, *target.shape[2:]).reshape(b * s * s, *target.shape[2:])
        return _snr_moments_plain(p_rep, t_rep, scale_invariant, zero_mean).reshape(b, s, s)
    eps = torch.finfo(preds.dtype).eps
    if zero_mean:
        target = target - target.mean(dim=-1, keepdim=True)
        preds = preds - preds.mean(dim=-1, keepdim=True)
    preds = preds.reshape(-1, group, preds.shape[-1])
    target = target.reshape(-1, group, target.shape[-1])
    if scale_invariant:
        alpha = ((preds * target).sum(dim=-1, keepdim=True).sum(dim=-2, keepdim=True) + eps) / (
            (target**2).sum(dim=-1, keepdim=True).sum(dim=-2, keepdim=True) + eps)
        target = alpha * target
    noise = target - preds
    value = ((target**2).sum(dim=-1).sum(dim=-1) + eps) / ((noise**2).sum(dim=-1).sum(dim=-1) + eps)
    return 10 * torch.log10(value)


def snr_moments(preds: Tensor, target: Tensor, scale_invariant: bool, zero_mean: bool, group: int = 1,
                pairs: bool = False) -> Tensor:
    """The SNR family's float32 values by the CUDA kernel: ``(R // group,)`` in rows mode, ``(B, S, S)`` in pairs.

    ``chip_smoke.py`` holds it against :func:`_snr_moments_plain` and a float64
    evaluation on the card.

    Args:
        preds, target: float32, contiguous, on one CUDA device, of one shape:
            ``(R, T)`` in rows mode, ``(B, S, T)`` with S up to
            ``MAX_SPEAKERS`` in pairs mode.
        scale_invariant: SI-SDR's (and SA-SDR's) scaled target, else SNR's.
        zero_mean: the sums centred on each row's mean.
        group: rows a value (SA-SDR's speakers); R must be a multiple of it.
            Rows mode only.
        pairs: every (target, estimate) pair of each item.

    Every check raises ``ValueError`` before anything is built or launched; a
    CUDA error of the launch raises ``RuntimeError``. An empty batch launches
    nothing.
    """
    for name, x in (("preds", preds), ("target", target)):
        if x.dtype != torch.float32:
            raise ValueError(f"snr_moments takes float32 `{name}`, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"snr_moments: `{name}` must be contiguous")
    if preds.shape != target.shape or preds.ndim != (3 if pairs else 2):
        raise ValueError(f"snr_moments takes preds and target of one shape, {'(B, S, T)' if pairs else '(R, T)'}, "
                         f"got {tuple(preds.shape)} and {tuple(target.shape)}")
    device = preds.device
    if target.device != device:
        raise ValueError(f"snr_moments: `target` is on {target.device}, expected {device}")
    speakers = preds.shape[1] if pairs else 1
    if pairs and (group != 1 or not 1 <= speakers <= MAX_SPEAKERS):
        raise ValueError(f"snr_moments' pairs mode takes 1 to {MAX_SPEAKERS} speakers and group 1, got {speakers} "
                         f"and {group}")
    units, length = preds.shape[0], preds.shape[-1]
    if group < 1 or units % group != 0 or units > MAX_UNITS:
        raise ValueError(f"snr_moments takes up to {MAX_UNITS} rows in whole groups, got {units} rows in groups of "
                         f"{group}")
    if device.type != "cuda":
        raise ValueError(f"snr_moments runs on CUDA tensors only, got them on {device}")
    out_shape = (units, speakers, speakers) if pairs else (units // group,)
    out = torch.empty(out_shape, dtype=torch.float32, device=device)
    if units == 0:
        return out
    g = plan(units, length, sm_count(device), group, speakers)
    n_sums = speakers * speakers + 4 * speakers
    second_level = g.cluster_units * g.cluster_chunks < group * g.chunks
    partials = torch.empty((units * (g.chunks // g.cluster_chunks) * n_sums if second_level else 0,),
                           dtype=torch.float64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    tickets = zero_tickets(device, stream, units // group)
    args = (preds.data_ptr(), target.data_ptr(), out.data_ptr(), partials.data_ptr(), tickets.data_ptr(), units,
            length, g.chunk, g.chunks, speakers, group, int(scale_invariant), int(zero_mean), stream)
    launch_on("snr_moments", device, _launch_fn(), args)
    snr_moments.launches += 1
    return out


snr_moments.launches = 0
