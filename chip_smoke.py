#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``torchmetrics_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Phases, each of which fails the run (non-zero exit) on any mismatch:

1. device: the card's name and power limit; CUDA is required, there is no
   CPU fallback;
2. build: every CUDA kernel of the port, compiled from ``csrc/`` at once;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it and the edge cases of its contract
   (threshold grids up to 4000 with split bin ranges, duplicate, NaN and
   +-inf thresholds, non-finite scores, C % 4 != 0, out-of-range targets
   and ignored rows), from a random non-zero int32 state; the new states
   must be exactly equal. Times are CUDA-event medians of one call with the
   L2 cache flushed before each (``time_ms``, the kernel record's ``ms`` and
   ``plain_ms``); the kernel is also timed per call of a run of calls back to
   back over copies of the inputs that overflow the L2 cache
   (``time_stream_ms``, the record's ``stream_ms``), and beside it one
   PyTorch kernel that reads the same scores (``probs.sum(0)``);
   ``coco_match``, the greedy COCO matcher, is held equal (``torch.equal``) to
   its plain version on every chunk that phase 6's mAP compute launches it on
   (the (class, image) items of the 5,000-image set, padded as the metric pads
   them; the first chunk is timed the same way), and on synthetic batches at
   B=1024 items, D=128 detections, A=4 area ranges, T=10 IoU thresholds and
   G=1, 2, 4, 8, 16, 32, 33, 64 ground truths (every lane-group width; B=256
   at G=256), D=8 (byte stores), thresholds of 1.0 over IoUs of exactly 1.0,
   all-crowd and all-ignored items, rows of equal IoUs, invalid rows inside
   the live extent and items with no valid row; ``confmat_multiclass``, the
   fused multiclass confusion-matrix update, is held equal (``torch.equal``)
   to its plain version from a random non-zero int32 state at ImageNet-1k's
   batch (1,024 x 1,000 float32, the first record row) and a Cityscapes-shaped
   batch ((2, 19, 1024, 2048) float32, int64 targets, ~5 % void 255), and at
   C = 2, 3, 19, 1000, 1001, S % 4 != 0, rows of NaN, ties, +-0.0 and -inf, targets C,
   C+3, -3 and -(C*C+1), out-of-range integer labels, ignore_index None, 255
   and -3, int32 and int64 targets, float16 and bfloat16 scores and an empty
   batch; at the two main-path shapes it is timed as the others are, beside
   ``torch.bincount(target * C + preds.argmax(1))`` (two PyTorch calls, a
   yardstick, not the record's single-call ``library_ms``);
   ``binned_confmat_multilabel``, the per-label binned update, is held equal
   (``torch.equal``) to its plain version at phase 8's COCO batch (256 x 80,
   T=100) and binary batch (1,024 x 1, T=200), with ignored elements, NaN and
   +-inf scores, unsorted, duplicate, NaN and +-inf thresholds, split bin
   ranges (T=4000), all-zero weights, L % 4 != 0 and L=1000; the two phase 8
   shapes are timed beside ``bucketize`` + two ``bincount`` + ``flip``/``cumsum``
   (several PyTorch calls, a yardstick); ``calibration_bins``, the fused
   calibration-error update, against its plain version at ImageNet-1k's batch
   as probabilities and as logits and at the binary batch (the three timed
   rows, beside ``softmax`` + ``max`` + ``bucketize`` + three ``bincount``),
   at C = 2, 3, 31, 33, 1001 and 2000, ``n_bins`` = 1, 15, 100 and the limit
   1023, with NaN, tie, +-inf, one-hot and bin-edge rows, ignored rows,
   float16 and bfloat16 scores and an empty batch: integer states equal (but
   that a row whose normalized confidence lies within 1e-5 of a bin edge,
   counted and printed, may move one count between the edge's two bins),
   ``conf_sum`` within 1e-5 relative (and 1e-6 absolute, for bins that hold
   almost nothing; plus such a row's confidence in those two bins), and two launches
   identical bit for bit; ``ranking_pairs``, the per-sample coverage, LRAP and
   ranking loss, against its plain version for each measure at MS-COCO's batch
   (256 x 80), (32, 1000) and (64, 4096) (the timed rows, beside the plain
   form), at L = 1, 31, 33 and the limit 12,288, with NaN, +-inf, tied,
   no-relevant and all-relevant rows and ignored labels: coverage and loss
   equal, LRAP within 1e-6 relative;
4. main path: the single-device eval step (``MulticlassAccuracy`` micro,
   ``MulticlassF1Score`` macro, ``MulticlassAUROC(thresholds=20)``,
   ``MeanSquaredError``) over an ImageNet-1k validation-sized set, 50,000
   samples x 1,000 classes in batches of 1,024, through ``update_state`` and
   ``compute_state``; every kernel of the path must have launched, and the
   first 4 batches rerun on the port's CPU path must give the same states;
   the device operations of one profiled AUROC update are listed with
   their device times;
5. sync: the multi-device step. The same 50,000 x 1,000 scores, split over
   the ranks in whole batches of 1,024 (the 848-row batch on the last rank),
   go through a ``MetricCollection`` (``MulticlassAccuracy`` micro,
   ``MulticlassF1Score`` macro, ``MulticlassAUROC(thresholds=20)``,
   ``MulticlassAveragePrecision(thresholds=None)``), one coalesced
   ``sync_states`` and ``compute_states`` on every rank, in two worlds: NCCL
   with one rank per card, and gloo with 4 ranks on card 0 (CUDA tensors).
   Every rank's synced state must equal a single-process run over all
   50,000 rows (integer leaves and the cat rows exactly), and AP be within
   1e-6 of it; the collectives, bytes a bucket and sync time are printed.
   A second collection (mean, sum, max, cat, R2 and Pearson, whose sync is
   its own) syncs the rows' top score and whether it is right, timed apart;
   every rank must equal the single-process run;
6. ragged: in the same two worlds, a different item count on every rank:
   ``ROUGEScore`` over 1,000 seeded sentence pairs and
   ``MeanAveragePrecision`` over a COCO-val2017-shaped seeded set (80
   classes, about 7 ground truths and 100 detections an image, 5,000 images),
   through ``sync_ragged_states`` and compute; the item counts must survive,
   the results equal a single-process run, and every rank's matcher launches
   be the chunks phase 3 checked; the single-process compute on rank 0 runs
   under ``torch.profiler`` for the matcher's device time and the device
   operations it spends most time in;
7. classification tower, one card, no sync: (i) the ImageNet-1k set through a
   ``MetricCollection`` of the confusion matrix, Cohen's kappa, MCC and the
   Jaccard index (C=1,000) with macro precision, recall and specificity, and
   the composite ``1 - MulticlassAccuracy(average="micro")`` (top-1 error);
   the compute groups formed on the first batch are given to the timed
   collection, so ``confmat_multiclass`` must launch once a batch, 49 times;
   (ii) mIoU and the confusion matrix over 24 Cityscapes-shaped images (of
   the val set's 500, cut for the run's time) in batches of 2,
   ``ignore_index=255``; (iii) eight multilabel metrics over a MS-COCO 2014
   val-shaped set, 40,504 images x 80 labels in batches of 256; (iv) binary
   selective prediction over (i)'s scores (max softmax score, target "top-1
   correct"). Every leg reruns its first 4 batches on the port's CPU path
   and needs equal int32 states, and prints its update medians and values;
8. the curve family, aggregation and regression, one card, no sync: (i) phase
   4's 50,000 x 1,000 scores through the exact ``MulticlassAUROC`` and
   ``MulticlassROC`` (a 200 MB cat state, one exact compute over 1,000
   columns, no kernel); (ii) (iii)'s MS-COCO-shaped 40,504 x 80 set in
   batches of 256 through ``MultilabelAUROC``, ``MultilabelAveragePrecision``
   and ``MultilabelPrecisionRecallCurve`` at ``thresholds=100`` (one compute
   group: exactly 159 ``binned_confmat_multilabel`` launches) and the exact
   ``MultilabelAveragePrecision``; (iii) (iv)'s 50,000 binary rows through the
   exact ``BinaryAUROC`` (also at ``max_fpr=0.05``), ``BinaryAveragePrecision``
   and ``BinaryROC`` and ``BinaryAUROC(thresholds=200)`` (exactly 49 launches
   at one label); (iv) NYU Depth V2's labelled test split's shape, 654 seeded
   480 x 640 depth maps in batches of 8, through seven regression metrics and
   the mean, max and running mean of the per-batch L1 loss. Every leg reruns
   its first 4 batches on the CPU path (integer states equal, float states and
   values within a stated tolerance); every other new class runs over a seeded
   10,000-row set and is held against the CPU path;
9. the rest of classification, one card, no sync: (i) phase 4's ImageNet-1k
   set, as probabilities and again as their logits, through a
   ``MetricCollection`` of ``MulticlassCalibrationError(n_bins=15)`` with norm
   l1, l2 and max (one compute group: one ``calibration_bins`` launch a
   batch), ``MulticlassHingeLoss`` in both modes, ``MulticlassExactMatch``,
   ``Dice(num_classes=1000)`` and ``MulticlassRecallAtFixedPrecision``
   (``thresholds=20``: one ``binned_confmat_multiclass`` launch a batch);
   (ii) phase 7 (iii)'s MS-COCO shape through the three ranking metrics
   (exactly 477 ``ranking_pairs`` launches), ``MultilabelExactMatch`` and
   recall at fixed precision with precision at fixed recall at
   ``thresholds=100`` (one group: 159 ``binned_confmat_multilabel``
   launches); (iii) phase 7 (iv)'s 50,000 binary rows through
   ``BinaryCalibrationError`` (49 launches in binary mode), ``BinaryHingeLoss``
   plain and squared, the exact ``BinarySensitivityAtSpecificity`` and
   ``BinarySpecificityAtSensitivity(thresholds=200)`` (49 launches at one
   label); (iv) ``BinaryFairness`` and ``BinaryGroupStatRates`` over the
   CelebA test split's shape (19,962 seeded rows, two groups); (v)
   ``Dice(num_classes=19)`` on a Cityscapes-shaped batch with void 255
   raises the JAX package's ``ValueError``. Every leg reruns its first 4
   batches on the CPU path (integers equal, floats within 1e-5 relative).

Phases 5 and 6 run each rank as a process of its own (this script with
``--worker``); every kernel must have launched on the paths that run it.

The line before the last is the kernel record (JSON); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import datetime
import importlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12

N_SAMPLES, N_CLASSES, BATCH = 50_000, 1_000, 1_024  # ILSVRC2012 validation set
SEED = 0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, flush: torch.Tensor, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, by CUDA events, L2 flushed before each rep."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


L2_BYTES = 50 * 2**20
HOST_US_PER_CALL = 200  # the spin before a timed run allows this much host time a call


def copies_for(set_bytes: int) -> int:
    """Copies of one input set that hold more than twice the L2 cache together."""
    return max(2, -(-2 * L2_BYTES // set_bytes))


def time_stream_ms(fn, arg_sets, calls: int, runs: int = 3) -> float:
    """Device ms per call of ``fn``, called back to back as an eval loop calls it.

    ``arg_sets`` are copies of the same inputs, more than twice the L2 cache in
    all (``copies_for``), taken in turn, so each call finds its inputs cold.
    A spin kernel holds the card while the host enqueues the ``calls`` calls,
    so the time between the CUDA events is the device's alone; the run fails
    if the host was not done before the spin ended. Median of ``runs`` runs.
    """
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    per_call, host_us = [], HOST_US_PER_CALL
    while len(per_call) < runs:
        spin_start, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin_start.record()
        # cycles at the H100's 1.98 GHz boost clock: at a lower clock the spin lasts longer
        torch.cuda._sleep(int(calls * host_us * 1e-6 * 1.98e9))
        start.record()
        t0 = time.perf_counter()
        for i in range(calls):
            fn(*arg_sets[i % len(arg_sets)])
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms < spin_start.elapsed_time(start):
            per_call.append(start.elapsed_time(end) / calls)
        else:  # the card caught up with the host: spin longer and run again
            check(host_us < 16 * HOST_US_PER_CALL, f"the host took {host_ms:.3f} ms to enqueue {calls} calls")
            host_us *= 2
    return statistics.median(per_call)


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    info = {
        "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    print(f"[device] {info['name']} x{info['count']}, torch {info['torch']}, CUDA {info['cuda']}")
    return info


def phase_build() -> float:
    from torchmetrics_tpu_torch.kernels import _build

    sources = sorted(p[:-3] for p in os.listdir(_build.CSRC_DIR) if p.endswith(".cu"))
    t0 = time.perf_counter()
    logs = _build.build(sources)
    seconds = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {len(sources)} source(s) {sources}, {len(logs)} compiled in {seconds:.2f} s")
    return seconds


def _confmat_inputs(n: int, c: int, thresholds, zero_weight_share: float, edits, gen: torch.Generator):
    """A formatted batch ``(probs, target, weights, thresholds)`` on the card and a random non-zero int32 state."""
    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg

    dev = torch.device("cuda")
    thr = _adjust_threshold_arg(thresholds, dev)
    logits = 3.0 * torch.randn((n, c), generator=gen, device=dev)
    probs = torch.softmax(logits, dim=1)
    target = torch.randint(0, c, (n,), generator=gen, device=dev, dtype=torch.int32)
    # scores exactly on thresholds, where `>=` decides the bin
    finite = thr[torch.isfinite(thr)]
    rows = torch.arange(0, n, 5, device=dev)
    probs[rows, rows % c] = finite[rows % finite.shape[0]]
    probs[rows, target[rows].long()] = finite[(rows + 1) % finite.shape[0]]
    weights = (torch.rand((n,), generator=gen, device=dev) >= zero_weight_share).to(torch.float32)
    target = torch.where(weights == 0, 0, target)  # as _multiclass_prc_format leaves an ignored row
    if "nonfinite_scores" in edits:
        for i, value in enumerate([float("nan"), float("inf"), float("-inf")]):
            probs[i::7, 3 + 2 * i] = value
            probs[torch.arange(3 + i, n, 11, device=dev), target[3 + i :: 11].long()] = value  # true classes too
    if "out_of_range" in edits:
        for i, value in enumerate([c, c + 3, -3]):
            target[i::6] = value
    state = torch.randint(-(2**20), 2**20, (thr.shape[0], c, 2, 2), generator=gen, device=dev, dtype=torch.int32)
    return probs.contiguous(), target, weights, thr, state


def phase_kernels(flush: torch.Tensor) -> dict:
    from torchmetrics_tpu_torch.functional.classification import precision_recall_curve as prc
    from torchmetrics_tpu_torch.kernels import binned_confmat as kbc

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    unsorted37 = torch.rand((37,), generator=gen, device="cuda").tolist()
    nan, inf = float("nan"), float("inf")
    # duplicates, NaN, +-inf, signed zeros and a finite span that overflows float32
    edge_list = [0.5, nan, 0.1, inf, -inf, 0.1, nan, 0.0, -0.0, 1.0, 0.9, 0.5, 0.05, -3e38, 3e38]
    cases = [  # (what, rows, classes, thresholds, share of zero weights, edits); the first is the main path's
        ("slice", BATCH, N_CLASSES, 20, 0.0, ()),
        ("ragged last batch", N_SAMPLES % BATCH, N_CLASSES, 20, 0.0, ()),
        ("fine grid", BATCH, N_CLASSES, 200, 0.0, ()),
        ("unsorted list, ~10% zero weights", BATCH, N_CLASSES, unsorted37, 0.1, ()),
        ("grid of 1000", BATCH, N_CLASSES, 1000, 0.0, ()),
        ("grid of 4000, bin ranges split", 256, N_CLASSES, 4000, 0.0, ()),
        ("duplicate, NaN and +-inf thresholds", BATCH, N_CLASSES, edge_list, 0.0, ()),
        ("NaN and +-inf scores", BATCH, N_CLASSES, 20, 0.0, ("nonfinite_scores",)),
        ("C % 4 != 0, scalar loads", BATCH, N_CLASSES + 1, 20, 0.0, ()),
        ("out-of-range targets, ~10% ignored rows", BATCH, N_CLASSES, 20, 0.1, ("out_of_range",)),
    ]
    rows = []
    for what, n, c, thresholds, zero_share, edits in cases:
        p, t, w, thr, state = _confmat_inputs(n, c, thresholds, zero_share, edits, gen)
        n_thr = thr.shape[0]
        sorted_thr, order = prc._sort_thresholds(thr)
        geometry = kbc.plan(n, c, n_thr, torch.cuda.get_device_properties(0).multi_processor_count)
        label = f"{what} N={n} C={c} T={n_thr}"
        before = state.clone()
        got = kbc.binned_confmat_multiclass(state, p, t, w, sorted_thr, order)
        want = prc._binned_confmat_multiclass_accumulate_plain(state, p, t, w, thr, c)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"fused update and plain state differ ({label}): max abs err {err}")
        check(torch.equal(state, before), f"the fused update wrote into the old state ({label})")
        check(int((want - state)[..., 1, :].sum()) > 0, f"no positive rows counted ({label})")
        if what == "slice":  # the per-batch counts function takes the kernel on the card too
            check(torch.equal(prc._binned_confmat_multiclass(p, t, w, thr, c),
                              prc._binned_confmat_multiclass_plain(p, t, w, thr, c)), "per-batch counts differ")
        if "split" in what:
            check(geometry.grid[2] > 1, f"bins were not split ({label}: {geometry})")
        # least work of the fused update: read probs, target, weights, the sorted
        # thresholds and their order, and the old state once, write the new state
        # once; bin each score with ceil(log2(T+1)) compares, plus the two suffix
        # sums over (T+1) x C bins. The count of a design that compares every
        # score with every threshold, 2*N*C*T (a compare and an add per
        # (n, c, t)), is printed beside it.
        nbytes = n * c * 4 + n * 4 * 2 + n_thr * 4 * 2 + 2 * n_thr * c * 16
        nops = n * c * math.ceil(math.log2(n_thr + 1)) + 2 * c * (n_thr + 1)
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_OPS_PER_S * 1e3

        # times: one call after an L2 flush (the record's `ms` and `plain_ms`),
        # and per call back to back over cold copies of the inputs (`stream_ms`)
        fused = lambda s, p_, t_, w_: kbc.binned_confmat_multiclass(s, p_, t_, w_, sorted_thr, order)  # noqa: E731
        kernel_ms = time_ms(lambda: fused(state, p, t, w), flush)
        plain_ms = time_ms(lambda: prc._binned_confmat_multiclass_accumulate_plain(state, p, t, w, thr, c), flush)
        read_ms = time_ms(lambda: p.sum(0), flush)  # one PyTorch kernel that reads the same scores once
        sets = [(state, p, t, w)] + [tuple(x.clone() for x in (state, p, t, w))
                                     for _ in range(copies_for(nbytes) - 1)]
        stream_ms = time_stream_ms(fused, sets, calls=len(sets) * max(1, 96 // len(sets)))
        del sets
        # after the timed launches, each with its own scratch from the caching allocator, still exact
        check(torch.equal(fused(state, p, t, w), want), f"fused update differs after the timed launches ({label})")
        row = {
            "case": label, "n": n, "c": c, "t": n_thr, "max_abs_err": err, "plan": geometry._asdict(),
            "ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms, "read_ms": read_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": nops, "all_pairs_ops": 2 * n * c * n_thr, "library_ms": None,
        }
        print(
            f"[kernel] binned_confmat_multiclass {label}: exact, fused update {kernel_ms:.4f} ms after an L2 flush "
            f"({stream_ms:.4f} ms a call back to back; tile {geometry.tile_c} classes, grid {geometry.grid}), "
            f"plain {plain_ms:.4f} ms, probs.sum(0) {read_ms:.4f} ms, "
            f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: {nbytes} bytes, {nops} ops; "
            f"{row['all_pairs_ops']} ops comparing every score with every threshold), library_ms: none"
        )
        rows.append(row)
    return {"binned_confmat_multiclass": rows}


def _multilabel_inputs(n: int, labels: int, thresholds, zero_weight_share: float, edits, gen: torch.Generator):
    """A formatted multilabel batch ``(probs, target, weights, thresholds)`` on the card (sigmoid scores,
    ~30 % positives, some scores exactly on thresholds) and a random non-zero int32 state."""
    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg

    dev = torch.device("cuda")
    thr = _adjust_threshold_arg(thresholds, dev)
    probs = torch.sigmoid(2.0 * torch.randn((n, labels), generator=gen, device=dev))
    target = (torch.rand((n, labels), generator=gen, device=dev) < 0.3).to(torch.int32)
    finite = thr[torch.isfinite(thr)]
    cells = torch.arange(0, n * labels, 5, device=dev)
    probs.view(-1)[cells] = finite[cells % finite.shape[0]]  # where `>=` decides the bin
    weights = (torch.rand((n, labels), generator=gen, device=dev) >= zero_weight_share).to(torch.float32)
    if "zero_weights" in edits:
        weights.zero_()
    target = torch.where(weights == 0, 0, target)  # as _multilabel_prc_format leaves an ignored element
    if "nonfinite_scores" in edits:
        for i, value in enumerate([float("nan"), float("inf"), float("-inf")]):
            probs.view(-1)[i::7] = value
    state = torch.randint(-(2**20), 2**20, (thr.shape[0], labels, 2, 2), generator=gen, device=dev, dtype=torch.int32)
    return probs.contiguous(), target, weights, thr, state


def _bucketize_bincount(probs, target, weights, sorted_thr):
    """The same counts by PyTorch calls, a yardstick: ``bucketize`` each score among the
    sorted thresholds, ``bincount`` of ``label * (T + 1) + bin`` weighted by ``w`` and by
    ``w * target``, and the suffix sums by ``flip`` + ``cumsum``."""
    n_thr, labels = sorted_thr.shape[0], probs.shape[1]
    bins = torch.bucketize(probs, sorted_thr, right=True)
    flat = (torch.arange(labels, device=probs.device) * (n_thr + 1) + bins).view(-1)
    hpos = torch.bincount(flat, weights=weights.view(-1), minlength=labels * (n_thr + 1)).view(labels, -1)
    htp = torch.bincount(flat, weights=(weights * target).view(-1), minlength=labels * (n_thr + 1)).view(labels, -1)
    return torch.flip(torch.cumsum(torch.flip(hpos, (1,)), 1), (1,)), torch.flip(torch.cumsum(torch.flip(htp, (1,)), 1), (1,))


ML_LABELS, ML_THRESHOLDS = 80, 100  # phase 8 (ii): MS-COCO's 80 labels at thresholds=100
BIN_THRESHOLDS = 200  # phase 8 (iii): BinaryAUROC(thresholds=200)
MAX_STREAM_COPIES = 200


def phase_multilabel_kernel(flush: torch.Tensor) -> list:
    """``binned_confmat_multilabel`` against its plain version on the card, timed at the
    two shapes phase 8 gives it: the COCO batch (256, 80) at T=100 (the first row) and
    the binary batch at one label, (1024, 1) at T=200."""
    prc = importlib.import_module("torchmetrics_tpu_torch.functional.classification.precision_recall_curve")
    from torchmetrics_tpu_torch.kernels import binned_confmat as kbc

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    nan, inf = float("nan"), float("inf")
    unsorted_dups = [0.7, 0.2, 0.2, 0.95, 0.01, 0.5, 0.5, 0.33, 0.9, 0.9]
    edge_list = [0.5, nan, 0.1, inf, -inf, 0.1, nan, 0.0, -0.0, 1.0, 0.9, 0.5, 0.05, -3e38, 3e38]
    cases = [  # (what, rows, labels, thresholds, share of ignored elements, edits); the first two are phase 8's
        ("COCO batch (a)", COCO_ML_BATCH, ML_LABELS, ML_THRESHOLDS, 0.0, ()),
        ("binary batch, one label (b)", BATCH, 1, BIN_THRESHOLDS, 0.0, ()),
        ("last binary batch, one label", N_SAMPLES % BATCH, 1, BIN_THRESHOLDS, 0.0, ()),
        ("~15% ignore_index elements", COCO_ML_BATCH, ML_LABELS, ML_THRESHOLDS, 0.15, ()),
        ("one label, ~15% ignored", BATCH, 1, BIN_THRESHOLDS, 0.15, ()),
        ("NaN and +-inf scores", COCO_ML_BATCH, ML_LABELS, ML_THRESHOLDS, 0.0, ("nonfinite_scores",)),
        ("one label, NaN and +-inf scores", BATCH, 1, BIN_THRESHOLDS, 0.0, ("nonfinite_scores",)),
        ("unsorted and duplicate thresholds", COCO_ML_BATCH, ML_LABELS, unsorted_dups, 0.0, ()),
        ("duplicate, NaN and +-inf thresholds", COCO_ML_BATCH, ML_LABELS, edge_list, 0.0, ()),
        ("grid of 4000, bin ranges split", COCO_ML_BATCH, ML_LABELS, 4000, 0.0, ()),
        ("all-zero weights", COCO_ML_BATCH, ML_LABELS, ML_THRESHOLDS, 0.0, ("zero_weights",)),
        ("L % 4 != 0, scalar loads", COCO_ML_BATCH, ML_LABELS + 1, ML_THRESHOLDS, 0.1, ()),
        ("L=1000", BATCH, 1000, 20, 0.05, ()),
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for what, n, labels, thresholds, zero_share, edits in cases:
        p, t, w, thr, state = _multilabel_inputs(n, labels, thresholds, zero_share, edits, gen)
        n_thr = thr.shape[0]
        sorted_thr, order = prc._sort_thresholds(thr)
        geometry = kbc.plan(n, labels, n_thr, sms, one_wave=True)  # as the launcher plans it
        label = f"{what} N={n} L={labels} T={n_thr}"
        before = state.clone()
        got = kbc.binned_confmat_multilabel(state, p, t, w, sorted_thr, order)
        want = prc._binned_confmat_multilabel_accumulate_plain(state, p, t, w, thr)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"binned_confmat_multilabel and plain state differ ({label}): max abs err {err}")
        check(torch.equal(state, before), f"the multilabel update wrote into the old state ({label})")
        added = int((want - state)[..., 1, :].sum())
        check(added > 0 or "zero_weights" in edits, f"no positive counted ({label})")
        check(added == 0 or "zero_weights" not in edits, f"zero weights counted ({label})")
        if "split" in what:
            check(geometry.grid[2] > 1, f"bins were not split ({label}: {geometry})")
        if labels == 1 and what.endswith("(b)"):  # the binary per-batch counts take the kernel on the card too
            check(torch.equal(prc._binned_curve_update(p[:, 0], t[:, 0], w[:, 0], thr),
                              prc._binned_confmat_multilabel_plain(p, t, w, thr)[:, 0]), "binary per-batch counts differ")
        if what.endswith("(a)"):
            check(torch.equal(prc._binned_confmat_multilabel(p, t, w, thr),
                              prc._binned_confmat_multilabel_plain(p, t, w, thr)), "multilabel per-batch counts differ")
        if not (what.endswith("(a)") or what.endswith("(b)")):
            rows.append({"case": label, "what": what, "max_abs_err": err, "plan": geometry._asdict()})
            continue
        # least work: read probs, target and weights, the sorted thresholds and their
        # order once, read the old state and write the new one; bin each score with
        # ceil(log2(T+1)) compares, plus the two suffix sums over (T+1) x L bins
        nbytes = 3 * n * labels * 4 + 2 * n_thr * 4 + 2 * n_thr * labels * 16
        nops = n * labels * math.ceil(math.log2(n_thr + 1)) + 2 * labels * (n_thr + 1)
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_OPS_PER_S * 1e3
        fused = lambda s, p_, t_, w_: kbc.binned_confmat_multilabel(s, p_, t_, w_, sorted_thr, order)  # noqa: E731
        kernel_ms = time_ms(lambda: fused(state, p, t, w), flush)
        plain_ms = time_ms(lambda: prc._binned_confmat_multilabel_accumulate_plain(state, p, t, w, thr), flush)
        bincount_ms = time_ms(lambda: _bucketize_bincount(p, t, w, sorted_thr), flush)
        # at most MAX_STREAM_COPIES copies: a call is three device operations, and more calls than the
        # launch queue holds would block the host behind the spin (the one-label batch's copies stay in L2)
        copies = min(copies_for(nbytes), MAX_STREAM_COPIES)
        sets = [(state, p, t, w)] + [tuple(x.clone() for x in (state, p, t, w)) for _ in range(copies - 1)]
        stream_ms = time_stream_ms(fused, sets, calls=len(sets) * max(1, 96 // len(sets)))
        del sets
        check(torch.equal(fused(state, p, t, w), want), f"multilabel update differs after the timed launches ({label})")
        row = {
            "case": label, "what": what, "n": n, "l": labels, "t": n_thr, "max_abs_err": err,
            "plan": geometry._asdict(), "ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms,
            "bucketize_bincount_ms": bincount_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes, "ops": nops,
            "library_ms": None,
        }
        print(
            f"[kernel] binned_confmat_multilabel {label}: exact, {kernel_ms:.4f} ms after an L2 flush "
            f"({stream_ms:.4f} ms a call back to back; tile {geometry.tile_c}, grid {geometry.grid}), "
            f"plain {plain_ms:.4f} ms, bucketize + 2 bincount + flip/cumsum (several calls, a yardstick) "
            f"{bincount_ms:.4f} ms, bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: {nbytes} bytes, "
            f"{nops} ops), library_ms: none"
        )
        rows.append(row)
    print(f"[kernel] binned_confmat_multilabel: exact on all {len(cases)} cases, the two above and "
          + "; ".join(r["what"] for r in rows if "ms" not in r))
    return rows


# ------------------------------------------------ calibration_bins and ranking_pairs
CE_BINS = 15  # phase 9: MulticlassCalibrationError(n_bins=15), BinaryCalibrationError(n_bins=15)
EDGE_TOL = 1e-5  # a confidence this close to a bin edge may land on either side (expf and sum order)


def _ce_case(n, c, gen, logits=False, dtype=torch.float32, edits=()):
    """Scores (N, C) (C None: binary (N,)) of ``dtype`` and int64 targets on the card."""
    dev = torch.device("cuda")
    if c is None:
        scores = torch.sigmoid(2.0 * torch.randn((n,), generator=gen, device=dev))
        target = (torch.rand((n,), generator=gen, device=dev) < scores).to(torch.int64)
    else:
        target = torch.randint(0, c, (n,), generator=gen, device=dev)
        raw = 2.0 * torch.randn((n, c), generator=gen, device=dev)
        raw[torch.arange(n, device=dev), target] += 4.0 * (torch.rand((n,), generator=gen, device=dev) < 0.7)
        scores = raw if logits else torch.softmax(raw, 1)
    if n and c is not None and "edge_rows" in edits:  # NaN, ties, +-inf, one-hot (confidence exactly 1.0)
        nan, inf = float("nan"), float("inf")
        scores[0::11] = nan
        scores[1::11, c // 2] = nan
        scores[2::11] = 0.25 if not logits else 3.0  # all tied: the first index wins
        scores[3::11, 0], scores[3::11, c - 1] = scores[3::11].amax(1), scores[3::11].amax(1)
        scores[4::11] = 0.0
        scores[4::11, c - 1] = 1.0  # confidence exactly 1.0: the last bin
        if logits:
            scores[5::11, 1] = inf
            scores[6::11] = -inf
        scores[7::11, 0] = 1.0 / 3.0  # on k / n_bins edges when the row stays raw
        scores[8::11, 0] = 0.5
    if n and c is None and "edge_rows" in edits:
        scores[0::13] = float("nan")
        scores[1::13] = 1.0
        scores[2::13] = 0.0
        scores[3::13] = 0.2  # k / 15 for k = 3 once scaled
        scores[4::13] = 2.0 / 3.0
    if "ignored" in edits:
        target[torch.rand(target.shape, generator=gen, device=dev) < 0.1] = -1
    return scores.to(dtype).contiguous(), target


def _ce_edge_slack(preds: torch.Tensor, target: torch.Tensor, num_classes, n_bins: int, ignore_index=None):
    """What the rows on a bin edge may move, a bin: ``(edge rows, rows a bin, confidence a bin)``.

    A counted row whose plain confidence lies within EDGE_TOL of an edge k / n_bins may land in
    bin k - 1 or k (the kernel's ``expf`` and sum order against PyTorch's), so it adds one row
    and its confidence to the slack of both bins. Where the batch is not normalized both bin the
    same float32 confidence: no slack."""
    ce = importlib.import_module("torchmetrics_tpu_torch.functional.classification.calibration_error")
    if num_classes is None:
        conf, _, weights = ce._binary_ce_confidences(preds, target, ignore_index)
    else:
        conf, _, weights = ce._multiclass_ce_confidences(preds, target, num_classes, ignore_index)
    rows = torch.zeros((n_bins + 1,), dtype=torch.float64)
    confs = torch.zeros_like(rows)
    if not bool(((preds < 0) | (preds > 1)).any()):
        return 0, rows, confs
    scaled = conf.double().cpu() * n_bins
    edge = scaled.round()
    near = ((scaled - edge).abs() < EDGE_TOL * n_bins) & (weights.cpu() > 0)
    edge, near_conf = edge[near].long(), conf.double().cpu()[near]
    for b in (edge - 1, edge):
        inside = (b >= 0) & (b <= n_bins)
        rows.index_add_(0, b[inside], torch.ones_like(near_conf[inside]))
        confs.index_add_(0, b[inside], near_conf[inside])
    return int(near.sum()), rows, confs


def _ce_state_check(label, got, want, slack) -> float:
    """The kernel's ``(conf_sum, acc_sum, count)`` against the plain version's: each integer bin
    equal but for its slack rows (``_ce_edge_slack``), with equal totals; each ``conf_sum`` bin
    within 1e-5 relative plus its slack confidence, NaN where the plain version has NaN.
    Returns the max abs error of ``conf_sum``."""
    (gc, ga, gn), (wc, wa, wn) = [[x.cpu() for x in t] for t in (got, want)]
    _, rows, confs = slack
    for name, g, w in (("acc_sum", ga, wa), ("count", gn, wn)):
        off = (g.long() - w.long()).abs()
        check(bool((off <= rows).all()) and int(g.long().sum()) == int(w.long().sum()),
              f"calibration_bins {name} differs from plain by {off.tolist()} where the edge rows allow "
              f"{rows.long().tolist()} ({label})")
    check(torch.equal(gc.isnan(), wc.isnan()), f"calibration_bins conf_sum NaN placement differs ({label})")
    finite = ~wc.isnan()
    err = (gc[finite].double() - wc[finite].double()).abs()
    allowed = 1e-5 * wc[finite].double().abs() + confs[finite] + 1e-6
    check(bool((err <= allowed).all()), f"calibration_bins conf_sum differs ({label}): max abs err {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def _softmax_bucketize_bincount(preds, target, n_bins, edges):
    """The update by PyTorch calls, a yardstick: softmax, max over the classes, bucketize
    into the bin edges, and three bincounts."""
    probs = torch.softmax(preds, 1)
    conf, pred = probs.max(1)
    bins = torch.bucketize(conf, edges, right=True) - 1
    acc = (pred == target).to(torch.float32)
    return (torch.bincount(bins, weights=conf, minlength=n_bins + 1), torch.bincount(bins, weights=acc, minlength=n_bins + 1),
            torch.bincount(bins, minlength=n_bins + 1))


def phase_calibration_kernel(flush: torch.Tensor) -> list:
    """``calibration_bins`` against its plain version on the card, and its times at the main
    path's shapes: ImageNet-1k's batch as probabilities (the first row) and as logits, and
    the binary batch."""
    from torchmetrics_tpu_torch.kernels import calibration as kce

    ce = importlib.import_module("torchmetrics_tpu_torch.functional.classification.calibration_error")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    limit = kce.MAX_BINS
    cases = [  # (what, rows, classes (None: binary), n_bins, kwargs, ignore_index); the first three are timed
        ("ImageNet-1k batch, probabilities (a)", BATCH, N_CLASSES, CE_BINS, {}, None),
        ("ImageNet-1k batch, logits (b)", BATCH, N_CLASSES, CE_BINS, {"logits": True}, None),
        ("binary batch (c)", BATCH, None, CE_BINS, {}, None),
        ("last ImageNet batch, logits", N_SAMPLES % BATCH, N_CLASSES, CE_BINS, {"logits": True}, None),
        ("C=2", BATCH, 2, CE_BINS, {}, None),
        ("C=3, logits", BATCH, 3, CE_BINS, {"logits": True}, None),
        ("C=31: a thread a row", BATCH, 31, CE_BINS, {"logits": True}, None),
        ("C=33: a warp a row, scalar loads", BATCH, 33, CE_BINS, {"logits": True}, None),
        ("C=1001, scalar loads", BATCH, 1001, CE_BINS, {"logits": True}, None),
        ("C=2000: rows re-read from L2", 256, 2000, CE_BINS, {"logits": True}, None),
        ("n_bins=1", BATCH, N_CLASSES, 1, {}, None),
        ("n_bins=100, logits", BATCH, N_CLASSES, 100, {"logits": True}, None),
        (f"n_bins={limit} (the limit)", BATCH, N_CLASSES, limit, {"logits": True}, None),
        ("binary, n_bins=100", BATCH, None, 100, {}, None),
        ("binary logits", BATCH, None, CE_BINS, {"logits": True}, None),
        ("NaN, tie, +-inf, one-hot and edge rows, probabilities", BATCH, N_CLASSES, CE_BINS, {"edits": ("edge_rows",)}, None),
        ("NaN, tie, +-inf rows, logits", BATCH, N_CLASSES, CE_BINS, {"logits": True, "edits": ("edge_rows",)}, None),
        ("NaN, tie and edge rows, C=3", BATCH, 3, CE_BINS, {"edits": ("edge_rows",)}, None),
        ("binary NaN, 0, 1 and edge scores", BATCH, None, CE_BINS, {"edits": ("edge_rows",)}, None),
        ("~10% ignored rows (ignore_index=-1)", BATCH, N_CLASSES, CE_BINS, {"logits": True, "edits": ("ignored",)}, -1),
        ("ignored NaN rows", BATCH, N_CLASSES, CE_BINS, {"logits": True, "edits": ("edge_rows", "ignored")}, -1),
        ("binary, ~10% ignored", BATCH, None, CE_BINS, {"edits": ("ignored",)}, -1),
        ("ignore_index=255, none present", BATCH, N_CLASSES, CE_BINS, {}, 255),
        ("float16 logits", BATCH, N_CLASSES, CE_BINS, {"logits": True, "dtype": torch.float16}, None),
        ("bfloat16 probabilities", BATCH, N_CLASSES, CE_BINS, {"dtype": torch.bfloat16}, None),
        ("bfloat16 logits, C=33", BATCH, 33, CE_BINS, {"logits": True, "dtype": torch.bfloat16}, None),
        ("empty batch", 0, N_CLASSES, CE_BINS, {}, None),
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for what, n, c, n_bins, kwargs, ignore_index in cases:
        preds, target = _ce_case(n, c, gen, **kwargs)
        nb = n_bins + 1
        state = (100.0 * torch.rand((nb,), generator=gen, device="cuda"),
                 torch.randint(0, 2**20, (nb,), generator=gen, device="cuda", dtype=torch.int32),
                 torch.randint(0, 2**20, (nb,), generator=gen, device="cuda", dtype=torch.int32))
        got = kce.calibration_bins(*state, preds, target, c, ignore_index)
        again = kce.calibration_bins(*state, preds, target, c, ignore_index)
        want = ce._calibration_accumulate_plain(state, preds, target, c, ignore_index)
        torch.cuda.synchronize()
        slack = _ce_edge_slack(preds, target, c, n_bins, ignore_index)
        edge_rows = slack[0]
        label = f"{what}: preds {tuple(preds.shape)} {str(preds.dtype)[6:]}, n_bins {n_bins}, ignore_index {ignore_index}"
        err = _ce_state_check(label, got, want, slack)
        check(all(torch.equal(g.view(torch.int32), a.view(torch.int32)) for g, a in zip(got, again)),
              f"calibration_bins is not deterministic bit for bit ({label})")
        added = int((want[2] - state[2]).sum())
        check(added > 0 or n == 0, f"no row counted ({label})")
        geometry = kce.plan(n, c, n_bins, sms) if n else None
        if not what.endswith(("(a)", "(b)", "(c)")):
            rows.append({"case": label, "what": what, "max_abs_err": err, "edge_rows": edge_rows,
                         "plan": geometry._asdict() if geometry else None})
            continue
        # least work: read the scores and the targets once, read and write the 3 (n_bins + 1) state
        # values; for the softmax a compare, a subtract, an exp and an add a score, and a divide and
        # a compare for the argmax of the probabilities (the sigmoid's four a binary score)
        nbytes = preds.numel() * preds.element_size() + n * target.element_size() + 2 * 12 * nb
        nops = preds.numel() * (6 if c else 4)
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_OPS_PER_S * 1e3
        kernel = lambda p_, t_: kce.calibration_bins(*state, p_, t_, c, ignore_index)  # noqa: E731
        kernel_ms = time_ms(lambda: kernel(preds, target), flush)
        plain_ms = time_ms(lambda: ce._calibration_accumulate_plain(state, preds, target, c, ignore_index), flush)
        edges = torch.linspace(0, 1, n_bins + 1, device="cuda")
        if c is None:
            yard = lambda: _softmax_bucketize_bincount(torch.stack([1 - preds, preds], 1), target, n_bins, edges)  # noqa: E731
        else:
            yard = lambda: _softmax_bucketize_bincount(preds, target, n_bins, edges)  # noqa: E731
        yard_ms = time_ms(yard, flush)
        copies = min(copies_for(nbytes), MAX_STREAM_COPIES)
        sets = [(preds, target)] + [(preds.clone(), target.clone()) for _ in range(copies - 1)]
        stream_ms = time_stream_ms(kernel, sets, calls=len(sets) * max(1, 96 // len(sets)))
        del sets
        after = kernel(preds, target)
        check(all(torch.equal(g.view(torch.int32), a.view(torch.int32)) for g, a in zip(got, after)),
              f"calibration_bins differs after the timed launches ({label})")
        row = {
            "case": label, "what": what, "max_abs_err": err, "edge_rows": edge_rows, "plan": geometry._asdict(),
            "ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms, "softmax_bucketize_bincount_ms": yard_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": nops, "library_ms": None,
        }
        print(f"[kernel] calibration_bins {label}: {kernel_ms:.4f} ms after an L2 flush ({stream_ms:.4f} ms a call "
              f"back to back; plan {tuple(geometry)}), plain {plain_ms:.4f} ms, softmax + max + bucketize + 3 bincount "
              f"(several calls, a yardstick) {yard_ms:.4f} ms, bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: "
              f"{nbytes} bytes, {nops} ops), {edge_rows} rows within {EDGE_TOL} of a bin edge, conf_sum max abs err "
              f"{err:.3g}, bit-identical over repeated launches, library_ms: none")
        rows.append(row)
    print(f"[kernel] calibration_bins: integer states equal to the plain version (but for the rows counted within "
          f"{EDGE_TOL} of a bin edge, each only in its two bins), conf_sum within 1e-5 relative (plus those rows' "
          f"confidences in their bins) and bit-identical over repeated launches on all {len(cases)} cases: "
          + "; ".join(f"{r['what']} ({r['edge_rows']} edge rows)" for r in rows if "ms" not in r))
    return rows


COCO_RANK_LABELS = 80  # phase 9 (ii): the MS-COCO-shaped batch (256, 80)


def _ranking_case(n, labels, gen, edits=(), target_dtype=torch.int32):
    """Scores (N, L) float32 (sigmoid, on a 0.01 grid for ties) and 0/1 targets (~3.6 % positive,
    at least one a row unless an edit says otherwise) on the card."""
    dev = torch.device("cuda")
    target = (torch.rand((n, labels), generator=gen, device=dev) < max(2.9 / labels, 0.05)).to(target_dtype)
    logits = 1.5 * torch.randn((n, labels), generator=gen, device=dev) + 3.0 * target
    scores = torch.round(torch.sigmoid(logits) * 100) / 100
    if n and "edge_rows" in edits:
        nan = float("nan")
        target[0::9] = 0  # no relevant label
        target[1::9] = 1  # every label relevant
        scores[2::9] = 0.5  # all tied
        scores[3::9, 0] = nan
        scores[4::9, labels - 1] = nan
        target[4::9, labels - 1] = 1  # a relevant NaN
        scores[5::9, 0] = float("inf")
        scores[6::9, 0] = float("-inf")
        target[6::9, 0] = 1
    if "ignored" in edits:
        target[torch.rand((n, labels), generator=gen, device=dev) < 0.1] = -1
    return scores.contiguous(), target.contiguous()


def phase_ranking_kernel(flush: torch.Tensor) -> list:
    """``ranking_pairs`` against its plain version on the card for each measure, and its times
    at MS-COCO's batch (the first three rows) and at (32, 1000) and (64, 4096)."""
    from torchmetrics_tpu_torch.kernels import ranking as krk

    rk = importlib.import_module("torchmetrics_tpu_torch.functional.classification.ranking")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    limit = krk.MAX_LABELS
    shapes = [  # (what, rows, labels, edits, ignore_index, timed)
        ("COCO batch", COCO_ML_BATCH, COCO_RANK_LABELS, (), None, True),
        ("(32, 1000)", 32, 1000, (), None, True),
        ("(64, 4096)", 64, 4096, (), None, True),
        ("L=1", 256, 1, (), None, False),
        ("L=31", 256, 31, ("edge_rows",), None, False),
        ("L=33", 256, 33, ("edge_rows",), None, False),
        (f"L={limit} (the limit)", 4, limit, (), None, False),
        ("COCO batch, NaN, +-inf, tie, none and all relevant rows", COCO_ML_BATCH, COCO_RANK_LABELS, ("edge_rows",),
         None, False),
        ("COCO batch, ~10% ignore_index=-1", COCO_ML_BATCH, COCO_RANK_LABELS, ("ignored",), -1, False),
        ("(32, 1000), edge rows and ignore_index=-1", 32, 1000, ("edge_rows", "ignored"), -1, False),
        ("COCO batch, ignore_index=255, none present", COCO_ML_BATCH, COCO_RANK_LABELS, (), 255, False),
        ("empty batch", 0, COCO_RANK_LABELS, (), None, False),
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for what, n, labels, edits, ignore_index, timed in shapes:
        target_dtype = torch.int64 if "ignored" in edits else torch.int32
        preds, target = _ranking_case(n, labels, gen, edits, target_dtype)
        for measure in ("lrap", "loss", "coverage"):
            got = krk.ranking_pairs(preds, target, measure, ignore_index)
            want = rk._ranking_per_sample_plain(preds, target, measure, ignore_index)
            torch.cuda.synchronize()
            label = f"{measure}, {what}: ({n}, {labels}), target {str(target.dtype)[6:]}, ignore_index {ignore_index}"
            check(got.shape == want.shape == (n,), f"ranking_pairs shape {tuple(got.shape)} ({label})")
            check(torch.equal(got.isnan(), want.isnan()), f"ranking_pairs NaN placement differs ({label})")
            ok = ~want.isnan()
            err = float((got[ok] - want[ok]).abs().max()) if bool(ok.any()) else 0.0
            if measure == "lrap":  # the fractions are summed in another order
                check(bool(((got[ok] - want[ok]).abs() <= 1e-6 * want[ok].abs() + 1e-7).all()),
                      f"ranking_pairs differs from plain ({label}): max abs err {err}")
            else:
                check(torch.equal(got[ok], want[ok]), f"ranking_pairs differs from plain ({label}): max abs err {err}")
            check(torch.equal(krk.ranking_pairs(preds, target, measure, ignore_index).view(torch.int32),
                              got.view(torch.int32)), f"ranking_pairs is not deterministic ({label})")
            geometry = krk.plan(n, labels, measure, sms) if n else None
            if not timed:
                rows.append({"case": label, "what": f"{measure}, {what}", "max_abs_err": err,
                             "plan": geometry._asdict() if geometry else None})
                continue
            # least work: read the scores and targets once and write a value a row; LRAP and the loss
            # need each label's count of valid, relevant or irrelevant labels scored at or above it,
            # which a sort of the row (L ceil(log2 L) compares) and a scan give; coverage a min and a count
            sort_ops = n * labels * max(1, math.ceil(math.log2(labels)))
            nops = {"lrap": sort_ops, "loss": sort_ops, "coverage": 2 * n * labels}[measure]
            nbytes = n * labels * (4 + target.element_size()) + 4 * n
            bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_OPS_PER_S * 1e3
            kernel = lambda p_, t_: krk.ranking_pairs(p_, t_, measure, ignore_index)  # noqa: E731
            kernel_ms = time_ms(lambda: kernel(preds, target), flush)
            plain = lambda: rk._ranking_per_sample_plain(preds, target, measure, ignore_index)  # noqa: E731
            plain_ms = time_ms(plain, flush, reps=5 if labels > 1000 else 30, warmup=1)
            copies = min(copies_for(nbytes), MAX_STREAM_COPIES)
            sets = [(preds, target)] + [(preds.clone(), target.clone()) for _ in range(copies - 1)]
            stream_ms = time_stream_ms(kernel, sets, calls=len(sets) * max(1, 96 // len(sets)))
            del sets
            row = {
                "case": label, "what": f"{measure}, {what}", "max_abs_err": err, "plan": geometry._asdict(),
                "ms": kernel_ms, "stream_ms": stream_ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "ops": nops, "library_ms": None,
            }
            print(f"[kernel] ranking_pairs {label}: {kernel_ms:.4f} ms after an L2 flush ({stream_ms:.4f} ms a call "
                  f"back to back; plan {tuple(geometry)}), plain (the JAX form, (N, L, L) temporaries; the yardstick) "
                  f"{plain_ms:.4f} ms, bound {row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}: {nbytes} bytes, "
                  f"{nops} ops), max abs err {err:.3g}, library_ms: none")
            rows.append(row)
    print(f"[kernel] ranking_pairs: coverage and loss equal to the plain version, LRAP within 1e-6 relative, "
          f"deterministic, on all {len(shapes) * 3} cases: " + "; ".join(r["what"] for r in rows if "ms" not in r))
    return rows


def _main_path_data(gen: torch.Generator):
    """Seeded eval-set stand-ins, made on the card: softmax probabilities of a
    classifier that adds logit mass to the true class on 3 rows in 4, integer
    targets, and regression value/reference pairs."""
    dev = torch.device("cuda")
    target = torch.randint(0, N_CLASSES, (N_SAMPLES,), generator=gen, device=dev)
    logits = 2.0 * torch.randn((N_SAMPLES, N_CLASSES), generator=gen, device=dev)
    boost = 6.0 * (torch.rand((N_SAMPLES,), generator=gen, device=dev) < 0.75)
    logits[torch.arange(N_SAMPLES, device=dev), target] += boost
    probs = torch.softmax(logits, dim=1)
    values = torch.randn((N_SAMPLES,), generator=gen, device=dev)
    references = values + 0.1 * torch.randn((N_SAMPLES,), generator=gen, device=dev)
    torch.cuda.synchronize()
    return probs, target, values, references


def _metrics(device):
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassAUROC, MulticlassF1Score
    from torchmetrics_tpu_torch.regression import MeanSquaredError

    return {
        "accuracy": MulticlassAccuracy(num_classes=N_CLASSES, average="micro", validate_args=False, device=device),
        "f1": MulticlassF1Score(num_classes=N_CLASSES, average="macro", validate_args=False, device=device),
        "auroc": MulticlassAUROC(num_classes=N_CLASSES, thresholds=20, validate_args=False, device=device),
        "mse": MeanSquaredError(device=device),
    }


def _batches(data, n_batches=None):
    probs, target, values, references = data
    starts = range(0, N_SAMPLES, BATCH)
    for start in list(starts)[:n_batches]:
        sl = slice(start, start + BATCH)
        yield {"cls": (probs[sl], target[sl]), "reg": (values[sl], references[sl])}


def phase_main_path(kernels) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    data = _main_path_data(gen)
    print(f"[main] data on the card: probs {tuple(data[0].shape)} float32 "
          f"({data[0].numel() * 4 / 1e6:.0f} MB), {N_SAMPLES} targets and regression pairs")
    metrics = _metrics("cuda")
    states = {k: m.init_state() for k, m in metrics.items()}
    times = {k: [] for k in metrics}
    early = None
    n_batches = 0

    for kernel in kernels:
        kernel.launches = 0
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    for batch in _batches(data):
        for name, metric in metrics.items():
            args = batch["reg"] if name == "mse" else batch["cls"]
            t0 = time.perf_counter()
            states[name] = metric.update_state(states[name], *args)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
        n_batches += 1
        if n_batches == 4:
            early = {k: {n: v.clone() for n, v in s.items()} for k, s in states.items()}
    results, compute_ms = {}, {}
    for name, metric in metrics.items():
        t0 = time.perf_counter()
        results[name] = metric.compute_state(states[name])
        torch.cuda.synchronize()
        compute_ms[name] = (time.perf_counter() - t0) * 1e3
    path_s = time.perf_counter() - t_path
    launches = {k.__name__: k.launches for k in kernels}

    expected_batches = -(-N_SAMPLES // BATCH)
    check(n_batches == expected_batches, f"{n_batches} batches, expected {expected_batches}")
    check(launches["binned_confmat_multiclass"] == expected_batches,
          f"binned_confmat_multiclass launched {launches['binned_confmat_multiclass']} times, expected {expected_batches}")
    for name, value in results.items():
        check(value.shape == () and bool(torch.isfinite(value)), f"{name} result {value} is not a finite scalar")
        check(value.dtype == torch.float32, f"{name} result dtype {value.dtype}")
    for name, state in states.items():
        check(int(state["_n"]) == expected_batches, f"{name} counted {int(state['_n'])} updates")
    check(int(states["accuracy"]["tp"].sum() + states["accuracy"]["fn"].sum()) == N_SAMPLES, "accuracy support")
    check(int(states["auroc"]["confmat"][0].sum()) == N_SAMPLES * N_CLASSES, "auroc cells at threshold 0")
    check(int(states["mse"]["total"]) == N_SAMPLES, "mse row count")

    # the first 4 batches again, on the port's CPU path (the plain versions)
    cpu_metrics = _metrics("cpu")
    cpu_states = {k: m.init_state() for k, m in cpu_metrics.items()}
    for batch in _batches(data, 4):
        for name, metric in cpu_metrics.items():
            args = batch["reg"] if name == "mse" else batch["cls"]
            cpu_states[name] = metric.update_state(cpu_states[name], *(a.cpu() for a in args))
    for name, cpu_state in cpu_states.items():
        for leaf, cpu_value in cpu_state.items():
            card_value = early[name][leaf].cpu()
            check(card_value.dtype == cpu_value.dtype, f"{name}.{leaf} dtype {card_value.dtype} vs {cpu_value.dtype}")
            if cpu_value.dtype == torch.int32:
                check(torch.equal(card_value, cpu_value), f"{name}.{leaf} differs between the card and the CPU")
            else:
                torch.testing.assert_close(card_value, cpu_value, rtol=1e-5, atol=0)

    # the first compute above also loads each new CUDA kernel's module; steady state:
    compute_steady_ms = {}
    for name, metric in metrics.items():
        samples = []
        for _ in range(10):
            t0 = time.perf_counter()
            metric.compute_state(states[name])
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        compute_steady_ms[name] = statistics.median(samples)
    pipelined_s, busy_s = _pipelined_pass(metrics, data)
    auroc_ops = _profiled_update_ops(metrics["auroc"], states["auroc"], next(_batches(data, 1))["cls"])

    record = {
        "batches": n_batches, "launches": launches, "path_s": path_s,
        "update_ms_median": {k: statistics.median(v) for k, v in times.items()},
        "compute_first_ms": compute_ms, "compute_ms": compute_steady_ms,
        "pipelined_pass_s": pipelined_s, "pipelined_samples_per_s": N_SAMPLES / pipelined_s,
        "profiled_device_busy_s": busy_s, "auroc_update_device_ops": auroc_ops,
        "results": {k: float(v) for k, v in results.items()},
    }
    for name in metrics:
        print(f"[main] {name}: update median {record['update_ms_median'][name]:.4f} ms/batch, "
              f"compute {compute_steady_ms[name]:.4f} ms (first call {compute_ms[name]:.4f} ms), "
              f"value {record['results'][name]:.6f}")
    print(f"[main] {n_batches} batches in {path_s:.3f} s (host clock, a synchronize after each update); "
          f"launches {launches}; first 4 batches match the CPU path")
    busy = "not measured" if busy_s is None else f"{busy_s:.4f} s of device time"
    print(f"[main] pipelined pass (no synchronize between updates): {pipelined_s:.4f} s, "
          f"{record['pipelined_samples_per_s']:.0f} samples/s; profiled pass: {busy}")
    print(f"[main] one profiled AUROC update_state runs {len(auroc_ops)} device operations: "
          f"{[f'{name[:60]}: {us:.2f} us' for name, us in auroc_ops]}")
    return record


def _profiled_update_ops(metric, state, args):
    """``(name, device us)`` of each device operation (kernel, memset, copy)
    of one ``update_state``, in launch order, by ``torch.profiler``."""
    metric.update_state(state, *args)
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        metric.update_state(state, *args)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return [(e.name, e.time_range.elapsed_us()) for e in sorted(events, key=lambda e: e.time_range.start)]


def _pipelined_pass(metrics, data):
    """Seconds for one pass over the set with no synchronize between updates,
    as an eval loop runs, and the device time of a second such pass under
    ``torch.profiler`` (kernels, copies and fills; ``None`` if the profiler
    records no device activity)."""

    def one_pass():
        states = {k: m.init_state() for k, m in metrics.items()}
        for batch in _batches(data):
            for name, metric in metrics.items():
                args = batch["reg"] if name == "mse" else batch["cls"]
                states[name] = metric.update_state(states[name], *args)
        for name, metric in metrics.items():
            metric.compute_state(states[name])
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_pass()
    seconds = time.perf_counter() - t0
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        one_pass()
    device_us = sum(
        e.time_range.elapsed_us() for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return seconds, (device_us / 1e6 if device_us > 0 else None)


# --------------------------------------------------------------- coco_match
COCO_THRS = [0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95]
SM_CLOCK_HZ = 1.98e9  # H100 SXM boost clock
DEP_OP_CYCLES = 4  # latency of one dependent FP32 operation, in cycles


def _match_inputs(n_items, n_dets, n_gts, thrs, edits, gen):
    """A padded matcher batch on the card: IoUs on a 0.05 grid (ties, and IoUs
    on the thresholds), ~10 % crowd ground truths, per-area ignore masks, items
    of 1..D real detections and 1..G real ground truths, padded rows of 0 and
    some rows of -inf; ``edits`` add the contract's edge cases."""
    dev = torch.device("cuda")
    n_areas = 4
    ious = torch.round(torch.rand((n_items, n_dets, n_gts), generator=gen, device=dev) * 20) / 20
    n_d = torch.randint(1, n_dets + 1, (n_items, 1), generator=gen, device=dev)
    n_g = torch.randint(1, n_gts + 1, (n_items, 1), generator=gen, device=dev)
    valid_d = torch.arange(n_dets, device=dev)[None, :] < n_d
    valid_g = torch.arange(n_gts, device=dev)[None, :] < n_g
    ious = torch.where(valid_d[:, :, None] & valid_g[:, None, :], ious, 0.0)
    ious[torch.arange(0, n_items, 7, device=dev), n_dets - 1] = -float("inf")  # an invalid row of -inf
    crowd = (torch.rand((n_items, n_gts), generator=gen, device=dev) < 0.1) & valid_g
    ignored = crowd[:, None, :] | (torch.rand((n_items, n_areas, n_gts), generator=gen, device=dev) < 0.25)
    if "one" in edits:  # IoUs of exactly 1.0, eligible at thr = 1.0
        ones = torch.rand((n_items, n_dets, n_gts), generator=gen, device=dev) < 0.1
        ious = torch.where(ones & valid_d[:, :, None] & valid_g[:, None, :], 1.0, ious)
    if "crowd_ignored" in edits:  # whole items all crowd, or all ignored
        crowd[0::2] = valid_g[0::2]
        ignored[1::2] = True
    if "ties" in edits:  # rows of equal IoUs: the last index must win
        ious[:, ::2] = torch.where(valid_g[:, None, :], 0.7, 0.0)
    if "gaps" in edits:  # invalid rows inside the live extent, keeping their IoUs: random ones and a run of them
        valid_d &= torch.rand(valid_d.shape, generator=gen, device=dev) < 0.7
        valid_d[:, n_dets // 4 : n_dets // 2] = False
    if "empty" in edits:  # every fifth item has no valid detection
        valid_d[::5] = False
    thr = torch.tensor(thrs, dtype=torch.float32, device=dev)
    return ious.contiguous(), crowd, ignored.contiguous(), valid_d, valid_g, thr


def _map_chunks() -> list:
    """The matcher's arguments of each launch of the mAP compute of phase 6:
    every (class, image) item of the 5,000-image set, in the metric's order,
    padded as the metric pads them, on the card."""
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision
    from torchmetrics_tpu_torch.detection.mean_ap import _matcher_items
    from torchmetrics_tpu_torch.functional.detection.matcher import padded_chunks

    metric = MeanAveragePrecision(device="cuda")
    state = _map_state(metric, torch.device("cuda"), range(MAP_IMAGES // MAP_BATCH))
    _, _, items = metric._class_items(state)
    flat = [it for per_class in items for it in per_class]
    return [args for _, args in padded_chunks(_matcher_items(flat), metric.iou_thresholds, "cuda")]


def _shape(args) -> tuple:
    """``(B, D, G, A, T)`` of the matcher's arguments, as ``coco_match.shapes`` counts them."""
    ious, _, ignored, _, _, thrs = args
    return (*ious.shape, ignored.shape[1], thrs.shape[0])


def phase_matcher(flush: torch.Tensor):
    """The matcher's rows (the first at phase 6's first chunk) and the count
    of phase 6's chunks by ``(B, D, G, A, T)``."""
    from torchmetrics_tpu_torch.functional.detection.matcher import _match_batch_plain
    from torchmetrics_tpu_torch.kernels import coco_match as kcm

    t0 = time.perf_counter()
    chunks = _map_chunks()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, args in enumerate(chunks):
        got, want = kcm.coco_match(*args), _match_batch_plain(*args)
        mismatches = [int((x != y).sum()) for x, y in zip(got, want)]
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"coco_match and plain differ on mAP chunk {i} {_shape(args)}: {mismatches}")
    shapes = collections.Counter(_shape(args) for args in chunks)
    print(f"[kernel] coco_match: exact on all {len(chunks)} chunks of the 5,000-image mAP compute, by (B, D, G, A, T) "
          f"{dict(shapes)} (items built and padded in {build_s:.2f} s, checked in {time.perf_counter() - t0:.2f} s)")

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    thr_one = COCO_THRS[:-1] + [1.0]
    cases = [  # (what, items, detections, ground truths, thresholds, edits); the first is phase 6's first chunk
        ("mAP chunk 0", chunks[0]),
        ("D=128, G=32", 1024, 128, 32, COCO_THRS, ()),
        ("G=8", 1024, 128, 8, COCO_THRS, ()),
        ("G=64, two gts a lane", 1024, 128, 64, COCO_THRS, ()),
        ("thr=1.0, IoUs of exactly 1.0", 1024, 128, 32, thr_one, ("one",)),
        ("all-crowd and all-ignored items", 1024, 128, 32, COCO_THRS, ("crowd_ignored",)),
        ("equal IoUs, last index wins", 1024, 128, 32, COCO_THRS, ("ties",)),
        ("G=256, tile read from device memory", 256, 128, 256, COCO_THRS, ()),
        ("G=1, a group of 8 lanes", 1024, 128, 1, COCO_THRS, ()),
        ("G=2", 1024, 128, 2, COCO_THRS, ()),
        ("G=4", 1024, 128, 4, COCO_THRS, ()),
        ("G=16", 1024, 128, 16, COCO_THRS, ()),
        ("G=33, two gts a lane", 1024, 128, 33, COCO_THRS, ()),
        ("G=128, four gts a lane", 1024, 128, 128, COCO_THRS, ()),
        ("gaps in valid_d", 1024, 128, 32, COCO_THRS, ("gaps",)),
        ("gaps and items with no valid row", 1024, 128, 8, COCO_THRS, ("gaps", "empty")),
        ("D=8, byte stores", 1024, 8, 8, COCO_THRS, ()),
    ]
    del chunks[1:]
    rows = []
    for what, *spec in cases:
        args = spec[0] if len(spec) == 1 else _match_inputs(*spec, gen)
        b, d, g, a, t = _shape(args)
        label = f"{what} B={b} D={d} G={g} A={a} T={t}"
        got = kcm.coco_match(*args)
        want = _match_batch_plain(*args)
        torch.cuda.synchronize()
        mismatches = [int((x != y).sum()) for x, y in zip(got, want)]
        check(all(torch.equal(x, y) for x, y in zip(got, want)), f"coco_match and plain differ ({label}): {mismatches}")
        check(bool(want[0].any()) and not bool(want[0].all()), f"a degenerate case ({label})")
        # least work: read the IoU rows of the valid detections, valid_d and the
        # gt masks once, write both maps once; a compare and an argmax step per
        # (b, a, t, d, g) of the valid detections. The scan's chain: the longest
        # live extent's dependent steps of a log2(G)-deep argmax and a carry
        # update, at DEP_OP_CYCLES a dependent operation
        valid_rows = int(args[3].sum())
        live = int((args[3] * torch.arange(1, d + 1, device=args[3].device)).amax())
        nbytes = 4 * g * valid_rows + b * d + b * g * 2 + b * a * g + t * 4 + 2 * b * a * t * d
        nops = 2 * a * t * g * valid_rows
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_OPS_PER_S * 1e3
        chain_ms = live * (math.ceil(math.log2(g)) + 2) * DEP_OP_CYCLES / SM_CLOCK_HZ * 1e3
        plan = kcm.launch_plan(d, g, a, t)
        kernel_ms = time_ms(lambda: kcm.coco_match(*args), flush)
        plain_ms = time_ms(lambda: _match_batch_plain(*args), flush, reps=5, warmup=1)
        sets = [args] + [tuple(x.clone() for x in args) for _ in range(copies_for(nbytes) - 1)]
        stream_ms = time_stream_ms(kcm.coco_match, sets, calls=len(sets) * max(1, 48 // len(sets)))
        del sets
        row = {
            "case": label, "max_abs_err": float(max(mismatches)), "ms": kernel_ms, "stream_ms": stream_ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "chain_ms": chain_ms,
            "bytes": nbytes, "ops": nops, "valid_rows": valid_rows, "live": live, "plan": plan._asdict(),
            "library_ms": None,
        }
        print(
            f"[kernel] coco_match {label}: exact, {kernel_ms:.4f} ms after an L2 flush "
            f"({stream_ms:.4f} ms a call back to back), plain {plain_ms:.4f} ms, bound {row['bound_ms'] * 1e3:.2f} us "
            f"({row['bound_by']}: {nbytes} bytes, {nops} ops; {valid_rows} valid rows, live extent up to {live}), "
            f"dependent chain {chain_ms * 1e3:.2f} us, library_ms: none; plan {tuple(plan)}"
        )
        rows.append(row)
    return rows, shapes


# ---------------------------------------------------------- confmat_multiclass
SEG_SHAPE = (2, 19, 1024, 2048)  # Cityscapes-shaped logits of one batch: 2 images, 19 classes, 1024 x 2048
SEG_IGNORE = 255  # Cityscapes' void label


def _seg_batch(gen: torch.Generator, dtype=torch.float32):
    """A Cityscapes-shaped batch on the card: logits (2, 19, 1024, 2048) with the
    true class boosted on 3 pixels in 4, int64 targets, ~5 % of them 255."""
    dev = torch.device("cuda")
    n, c, h, w = SEG_SHAPE
    target = torch.randint(0, c, (n, h, w), generator=gen, device=dev)
    logits = torch.randn(SEG_SHAPE, generator=gen, device=dev, dtype=dtype)
    boost = 4.0 * (torch.rand((n, 1, h, w), generator=gen, device=dev) < 0.75).to(dtype)
    logits.scatter_add_(1, target[:, None], boost)
    target[torch.rand((n, h, w), generator=gen, device=dev) < 0.05] = SEG_IGNORE
    return logits, target


def _confmat_case(n, c, spatial, gen, dtype=torch.float32, target_dtype=torch.int64, edits=()):
    """Scores (N, C, *S) of ``dtype`` (or int32 labels with "labels") and targets (N, *S) on the card."""
    dev = torch.device("cuda")
    shape = (n, *spatial)
    target = torch.randint(0, c, shape, generator=gen, device=dev, dtype=target_dtype)
    scores = torch.randn((n, c, *spatial), generator=gen, device=dev).to(dtype)
    if n and "edge_rows" in edits:  # where the argmax rule decides: NaN, ties, signed zeros, all -inf
        nan, inf = float("nan"), float("inf")
        rows = scores.view(n, c, -1)[:, :, 0]
        rows[0::9] = nan
        rows[1::9, c // 2] = nan
        rows[1::9, c - 1] = nan
        rows[2::9] = 0.25
        rows[3::9, 0], rows[3::9, c - 1] = 7.0, 7.0
        rows[4::9] = -0.0
        rows[4::9, c - 1] = 0.0
        rows[5::9] = -inf
        rows[6::9, c - 1] = inf
        rows[7::9] = -inf
        rows[7::9, c // 2] = nan
    if n and "out_of_range" in edits:  # wrapped (C, C+3, -3) and dropped (-(C*C+1)) flat indices
        flat = target.view(-1)
        for i, value in enumerate([c, c + 3, -3, -(c * c + 1)]):
            flat[i::10] = value
    if "labels" in edits:
        scores = torch.randint(-3, c + 3, shape, generator=gen, device=dev, dtype=torch.int32)  # out of range too
    return scores.contiguous(), target


def phase_confmat(flush: torch.Tensor) -> list:
    """``confmat_multiclass`` against its plain version on the card, and its times at
    the main path's shapes: ImageNet-1k's batch (the first row) and a Cityscapes batch."""
    from torchmetrics_tpu_torch.kernels import confmat as kcm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = [  # (what, batch or (N, C, spatial, kwargs), ignore_index); the first two are the main path's shapes
        ("ImageNet-1k batch (a)", (BATCH, N_CLASSES, (), {}), None),
        ("Cityscapes batch (b)", _seg_batch(gen), SEG_IGNORE),
        ("C=2", (BATCH, 2, (), {}), None),
        ("C=3, spatial", (64, 3, (16, 16), {}), None),
        ("C=19, spatial, S % 4 != 0: a thread a pixel", (4, 19, (9, 7), {}), None),
        ("C=19", (BATCH, 19, (), {}), None),
        ("C=1001, scalar loads", (BATCH, 1001, (), {}), None),
        ("C=1000, NaN, tie, +-0.0 and -inf rows", (BATCH, N_CLASSES, (), {"edits": ("edge_rows",)}), None),
        ("C=19 spatial, NaN, tie, +-0.0 and -inf rows", (8, 19, (64, 64), {"edits": ("edge_rows",)}), None),
        ("C=3, NaN, tie, +-0.0 and -inf rows", (BATCH, 3, (), {"edits": ("edge_rows",)}), None),
        ("C=1000, targets C, C+3, -3, -(C*C+1)", (BATCH, N_CLASSES, (), {"edits": ("out_of_range",)}), None),
        ("C=19 spatial, targets C, C+3, -3, -(C*C+1)", (4, 19, (32, 32), {"edits": ("out_of_range",)}), None),
        ("C=19, out-of-range integer labels", (BATCH, 19, (8,), {"edits": ("labels",)}), None),
        ("C=1000, out-of-range integer labels", (BATCH, N_CLASSES, (), {"edits": ("labels",)}), None),
        ("C=19, ignore_index=-3", (4, 19, (32, 32), {"edits": ("out_of_range",)}), -3),
        ("C=1000, ignore_index=255", (BATCH, N_CLASSES, (), {}), 255),
        ("C=1000, int32 targets", (BATCH, N_CLASSES, (), {"target_dtype": torch.int32}), None),
        ("C=1000, float16 scores", (BATCH, N_CLASSES, (), {"dtype": torch.float16, "edits": ("edge_rows",)}), None),
        ("C=1000, bfloat16 scores", (BATCH, N_CLASSES, (), {"dtype": torch.bfloat16}), None),
        ("C=19 spatial, float16 scores", (4, 19, (32, 32), {"dtype": torch.float16, "edits": ("edge_rows",)}), None),
        ("C=19 spatial, bfloat16 scores", (4, 19, (32, 32), {"dtype": torch.bfloat16}), None),
        ("empty batch", (0, 19, (), {}), None),
    ]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for what, spec, ignore_index in cases:
        preds, target = spec if isinstance(spec[0], torch.Tensor) else _confmat_case(*spec[:3], gen, **spec[3])
        c = N_CLASSES if what.startswith("ImageNet") else (19 if what.startswith("City") else spec[1])
        state = torch.randint(-(2**20), 2**20, (c, c), generator=gen, device="cuda", dtype=torch.int32)
        got = kcm.confmat_multiclass(state.clone(), preds, target, ignore_index)
        want = kcm._confmat_multiclass_plain(state.clone(), preds, target, ignore_index)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        label = f"{what}: preds {tuple(preds.shape)} {str(preds.dtype)[6:]}, target {str(target.dtype)[6:]}, " \
                f"ignore_index {ignore_index}"
        check(torch.equal(got, want), f"confmat_multiclass and plain differ ({label}): max abs err {err}")
        added = int((want - state).sum())
        check(added > 0 or preds.numel() == 0, f"no pair counted ({label})")
        if not (what.endswith("(a)") or what.endswith("(b)")):
            rows.append({"case": label, "what": what, "max_abs_err": err, "added": added})
            continue
        # least work: read the scores and the targets once, read and write the state cells
        # this batch touches; compare every score once
        touched = int((want != state).sum())
        nbytes = preds.numel() * preds.element_size() + target.numel() * target.element_size() + 8 * touched
        nops = preds.numel()
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, nops / PEAK_FP32_OPS_PER_S * 1e3
        n, k, inner = kcm._layout(state, preds, target)
        plan = kcm.plan(n * inner, k, inner, c, False, sms)
        timed = state.clone()  # the timed launches add into it, far below 2**31
        kernel_ms = time_ms(lambda: kcm.confmat_multiclass(timed, preds, target, ignore_index), flush)
        plain_ms = time_ms(lambda: kcm._confmat_multiclass_plain(timed, preds, target, ignore_index), flush,
                           reps=10, warmup=1)
        two_call_ms = time_ms(lambda: torch.bincount(target.view(-1) * c + preds.argmax(1).view(-1), minlength=c * c),
                              flush, reps=10, warmup=1)
        sets = [(timed, preds, target)] + [(timed, preds.clone(), target.clone())
                                           for _ in range(copies_for(nbytes) - 1)]
        stream_ms = time_stream_ms(lambda s_, p_, t_: kcm.confmat_multiclass(s_, p_, t_, ignore_index), sets,
                                   calls=len(sets) * max(1, 48 // len(sets)))
        del sets
        after = kcm.confmat_multiclass(state.clone(), preds, target, ignore_index)
        check(torch.equal(after, want), f"confmat_multiclass differs after the timed launches ({label})")
        row = {
            "case": label, "max_abs_err": err, "added": added, "plan": plan._asdict(), "ms": kernel_ms,
            "stream_ms": stream_ms, "plain_ms": plain_ms, "two_call_ms": two_call_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": nops, "touched_cells": touched, "library_ms": None,
        }
        print(f"[kernel] confmat_multiclass {label}: exact, {kernel_ms:.4f} ms after an L2 flush "
              f"({stream_ms:.4f} ms a call back to back; plan {tuple(plan)}), plain {plain_ms:.4f} ms, "
              f"argmax + bincount (two calls, a yardstick) {two_call_ms:.4f} ms, bound {row['bound_ms'] * 1e3:.2f} us "
              f"({row['bound_by']}: {nbytes} bytes, {nops} compares; {touched} cells touched), library_ms: none")
        rows.append(row)
    print(f"[kernel] confmat_multiclass: exact on all {len(cases)} cases, the two above and "
          + "; ".join(r["what"] for r in rows if "ms" not in r))
    return rows


# ---------------------------------------------------- phases 5 and 6: ranks
WORLD_TIMEOUT_S = 420
SYNC_METRICS = ("acc", "f1", "auroc", "ap")
ROUGE_PAIRS, ROUGE_BATCH = 1_000, 50
MAP_IMAGES, MAP_BATCH, MAP_CLASSES = 5_000, 100, 80  # COCO val2017: 5,000 images, 80 classes
VOCAB = ("the a cat dog sat ran on in mat home fast slow red blue big small park street car tree man woman child "
         "ball game over under near far house road sky water").split()


def _rank_blocks(n_blocks: int, world: int, uneven: bool) -> list:
    """Contiguous block ranges of each rank: even, or in proportion 1 : 2 : ... : world."""
    weights = [r + 1 for r in range(world)] if uneven else [1] * world
    bounds = [round(n_blocks * sum(weights[:r]) / sum(weights)) for r in range(world + 1)]
    return [range(bounds[r], bounds[r + 1]) for r in range(world)]


def _sync_collection(device):
    from torchmetrics_tpu_torch.classification import (
        MulticlassAccuracy, MulticlassAUROC, MulticlassAveragePrecision, MulticlassF1Score,
    )
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "acc": MulticlassAccuracy(num_classes=N_CLASSES, average="micro", validate_args=False, device=device),
        "f1": MulticlassF1Score(num_classes=N_CLASSES, average="macro", validate_args=False, device=device),
        "auroc": MulticlassAUROC(num_classes=N_CLASSES, thresholds=20, validate_args=False, device=device),
        "ap": MulticlassAveragePrecision(num_classes=N_CLASSES, thresholds=None, validate_args=False, device=device),
    })


def _sync_collection2(device):
    """Phase 5's second collection: the sums, max and cat of the aggregators, R2 and
    Pearson's moments (its own sync), over the rows' top score and whether it is right."""
    from torchmetrics_tpu_torch import aggregation as agg, regression as reg
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "mean": agg.MeanMetric(device=device), "sum": agg.SumMetric(device=device), "max": agg.MaxMetric(device=device),
        "cat": agg.CatMetric(device=device), "pearson": reg.PearsonCorrCoef(device=device),
        "r2": reg.R2Score(device=device),
    })


def _collection2_inputs(probs, target) -> dict:
    conf, pred = probs.max(1)
    return {"value": conf, "preds": conf, "target": (pred == target).to(torch.float32)}


SYNC2_RTOL = 1e-5  # float sums and Pearson's pairwise merge against one pass in order; max and cat exact


def worker_sync(rank: int, world: int, device: torch.device) -> dict:
    """Phase 5 on one rank: this rank's whole batches of the 50,000 x 1,000
    set through the collection, one coalesced sync, compute; then the
    single-process run over all 50,000 rows on this rank, to compare."""
    import torch.distributed as dist

    from torchmetrics_tpu_torch.core.reductions import COLLECTIVES
    from torchmetrics_tpu_torch.kernels.binned_confmat import binned_confmat_multiclass
    from torchmetrics_tpu_torch.parallel.coalesce import plan_for_metrics

    data = _main_path_data(torch.Generator(device=device).manual_seed(SEED))
    batches = [b["cls"] for b in _batches(data)]
    mine = _rank_blocks(len(batches), world, uneven=False)[rank]
    col = _sync_collection(device)

    binned_confmat_multiclass.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states = col.init_states()
    for i in mine:
        states = col.update_states(states, *batches[i])
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    plan = plan_for_metrics([col[k] for k in states], [states[k] for k in states])
    dist.barrier()
    before = dict(COLLECTIVES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    synced = col.sync_states(states)
    torch.cuda.synchronize()
    sync_ms = (time.perf_counter() - t0) * 1e3
    collectives = {k: v - before.get(k, 0) for k, v in COLLECTIVES.items() if v - before.get(k, 0)}
    t0 = time.perf_counter()
    values = col.compute_states(synced)
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    launches = binned_confmat_multiclass.launches

    ref = col.init_states()
    for b in batches:
        ref = col.update_states(ref, *b)
    ref_values = col.compute_states(ref)
    leaves_equal = True
    for name in states:
        for leaf, want in ref[name].items():
            got = synced[name][leaf]
            if isinstance(want, tuple):  # rank after rank: the rows in the single-process order
                want = torch.cat(want)
                got = got[0] if len(got) == 1 else None
            leaves_equal &= got is not None and got.dtype == want.dtype and torch.equal(got, want)
    ap = synced["ap"]

    # the second collection, synced and timed apart: every rank against one process over every row
    col2 = _sync_collection2(device)
    states2 = col2.init_states()
    for i in mine:
        states2 = col2.update_states(states2, **_collection2_inputs(*batches[i]))
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    synced2 = col2.sync_states(states2)
    torch.cuda.synchronize()
    sync2_ms = (time.perf_counter() - t0) * 1e3
    values2 = col2.compute_states(synced2)
    ref2 = col2.init_states()
    for b in batches:
        ref2 = col2.update_states(ref2, **_collection2_inputs(*b))
    ref_values2 = col2.compute_states(ref2)
    equal2 = {}
    for k, want in ref_values2.items():
        got = values2[k]
        exact = k in ("max", "cat")
        equal2[k] = bool(got.shape == want.shape and (torch.equal(got, want) if exact else
                                                      torch.allclose(got, want, rtol=SYNC2_RTOL, atol=0)))
    return {
        "col2_sync_ms": sync2_ms, "col2_equal": equal2, "col2_cat_rows": int(values2["cat"].shape[0]),
        "col2_pearson_n": float(synced2["pearson"]["n_total"]),
        "col2_values": {k: float(v) for k, v in values2.items() if v.numel() == 1},
        "rank": rank, "batches": len(mine), "rows": sum(batches[i][0].shape[0] for i in mine),
        "launches": {"binned_confmat_multiclass": launches}, "update_s": update_s, "sync_ms": sync_ms,
        "compute_ms": compute_ms, "collectives": collectives, "bucket_bytes": plan.bucket_bytes(),
        "gathered_bytes": {k: ap[k][0].numel() * ap[k][0].element_size() for k in ("preds", "target", "weight")},
        "ap_rows": ap["preds"][0].shape[0], "n": {k: int(v["_n"]) for k, v in synced.items()},
        "leaves_equal": bool(leaves_equal), "values": {k: float(v) for k, v in values.items()},
        "ref_values": {k: float(v) for k, v in ref_values.items()},
    }


def _sentence_pairs(n: int):
    rng = np.random.default_rng(SEED + 3)
    preds, target = [], []
    for _ in range(n):
        ref = list(rng.choice(VOCAB, int(rng.integers(6, 25))))
        hyp = [w if rng.uniform() < 0.7 else str(rng.choice(VOCAB)) for w in ref]
        if rng.uniform() < 0.3:
            del hyp[int(rng.integers(0, len(hyp)))]
        preds.append(" ".join(hyp))
        target.append(" ".join(ref))
    return preds, target


def _coco_images(lo: int, hi: int):
    """Images ``lo..hi-1`` of a COCO-val2017-shaped seeded set: 640 x 480
    frames, 80 classes, about 7 ground truths an image (1% crowd), 100
    detections an image: 60 % jittered copies of the ground truths, most with
    their label, 40 % boxes anywhere; higher scores for the copies."""
    preds, targets = [], []
    for i in range(lo, hi):
        rng = np.random.default_rng((SEED + 4, i))
        n_gt = int(min(1 + rng.poisson(6), 50))
        wh = np.exp(rng.uniform(np.log(8), np.log(400), (n_gt, 2)))
        xy = rng.uniform(0, 1, (n_gt, 2)) * np.maximum(np.array([640, 480]) - wh, 1)
        gt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        gl = rng.integers(0, MAP_CLASSES, n_gt).astype(np.int32)
        n_copy = 60
        src = rng.integers(0, n_gt, n_copy)
        jitter = rng.normal(0, 0.1, (n_copy, 4)) * np.repeat(wh[src], 2, axis=1)
        copies = gt[src] + jitter
        dl_copy = np.where(rng.uniform(size=n_copy) < 0.85, gl[src], rng.integers(0, MAP_CLASSES, n_copy))
        rwh = np.exp(rng.uniform(np.log(8), np.log(400), (100 - n_copy, 2)))
        rxy = rng.uniform(0, 1, (100 - n_copy, 2)) * np.maximum(np.array([640, 480]) - rwh, 1)
        boxes = np.concatenate([copies, np.concatenate([rxy, rxy + rwh], 1)]).astype(np.float32)
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
        labels = np.concatenate([dl_copy, rng.integers(0, MAP_CLASSES, 100 - n_copy)]).astype(np.int32)
        scores = np.concatenate([rng.beta(4, 2, n_copy), rng.beta(2, 4, 100 - n_copy)]).astype(np.float32)
        preds.append({"boxes": boxes, "scores": scores, "labels": labels})
        targets.append({"boxes": gt, "labels": gl, "iscrowd": (rng.uniform(size=n_gt) < 0.01).astype(np.int32)})
    return preds, targets


def _on(device, items):
    return [{k: torch.from_numpy(v).to(device) for k, v in d.items()} for d in items]


def _map_state(metric, device, batch_ids):
    """``metric``'s state after the image batches ``batch_ids`` of the mAP set, on ``device``."""
    st = metric.init_state()
    for j in batch_ids:
        p, t = _coco_images(j * MAP_BATCH, min((j + 1) * MAP_BATCH, MAP_IMAGES))
        st = metric.update_state(st, _on(device, p), _on(device, t))
    return st


def _device_s(prof, name: str = "") -> float:
    """Device seconds of the operations a ``torch.profiler`` run recorded whose names hold ``name``."""
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name) / 1e6


def _top_device_ops(prof, n: int = 8) -> list:
    """``[name, device s, count]`` of the ``n`` device operations a ``torch.profiler`` run spent most time in."""
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e6
            by_name[e.name][1] += 1
    return sorted(([name[:90], s, c] for name, (s, c) in by_name.items()), key=lambda r: -r[1])[:n]


def worker_ragged(rank: int, world: int, device: torch.device) -> dict:
    """Phase 6 on one rank: ROUGE over its share of 1,000 sentence pairs and
    mAP over its share of the images, a different count on every rank, through
    the ragged sync and compute; then the single-process run to compare."""
    import torch.distributed as dist

    from torchmetrics_tpu_torch.core.reductions import COLLECTIVES
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision
    from torchmetrics_tpu_torch.kernels.coco_match import coco_match
    from torchmetrics_tpu_torch.parallel import sync_ragged_states
    from torchmetrics_tpu_torch.text import ROUGEScore

    out = {"rank": rank}
    preds, target = _sentence_pairs(ROUGE_PAIRS)
    blocks = _rank_blocks(ROUGE_PAIRS // ROUGE_BATCH, world, uneven=True)
    rouge = ROUGEScore(rouge_keys=("rouge1", "rougeL"), device=device)

    def rouge_state(block_ids):
        st = rouge.init_state()
        for j in block_ids:
            sl = slice(j * ROUGE_BATCH, (j + 1) * ROUGE_BATCH)
            st = rouge.update_state(st, preds[sl], target[sl])
        return st

    st = rouge_state(blocks[rank])
    dist.barrier()
    t0 = time.perf_counter()
    synced = sync_ragged_states(rouge._reductions, st)
    out["rouge_sync_ms"] = (time.perf_counter() - t0) * 1e3
    out["rouge_items"] = [v.shape[0] for v in synced["rouge1_fmeasure"]]
    out["rouge"] = {k: float(v) for k, v in rouge.compute_state(synced).items()}
    ref = rouge_state(range(ROUGE_PAIRS // ROUGE_BATCH))
    out["rouge_ref"] = {k: float(v) for k, v in rouge.compute_state(ref).items()}
    out["rouge_items_equal"] = all(
        len(synced[k]) == len(ref[k]) and all(torch.equal(a, b.cpu()) for a, b in zip(synced[k], ref[k]))
        for k in ref if k != "_n"
    )

    n_batches = -(-MAP_IMAGES // MAP_BATCH)
    blocks = _rank_blocks(n_batches, world, uneven=True)
    metric = MeanAveragePrecision(device=device)
    ranges = {"detection_labels": (0, MAP_CLASSES - 1), "groundtruth_labels": (0, MAP_CLASSES - 1),
              "groundtruth_crowds": (0, 1)}

    st = _map_state(metric, device, blocks[rank])
    out["images"] = len(st["detection_scores"])
    coco_match.launches = 0
    coco_match.shapes.clear()
    dist.barrier()
    before = dict(COLLECTIVES)
    t0 = time.perf_counter()
    synced = sync_ragged_states(metric._reductions, st, value_ranges=ranges)
    out["map_sync_ms"] = (time.perf_counter() - t0) * 1e3
    out["map_collectives"] = {k: v - before.get(k, 0) for k, v in COLLECTIVES.items() if v - before.get(k, 0)}
    out["map_items"] = len(synced["detection_scores"])
    t0 = time.perf_counter()
    value = metric.compute_state(synced)
    torch.cuda.synchronize()
    out["map_compute_s"] = time.perf_counter() - t0
    out["launches"] = {"coco_match": coco_match.launches}
    out["shapes"] = [[list(shape), n] for shape, n in coco_match.shapes.items()]
    out["map"] = {k: float(v) for k, v in value.items() if v.numel() == 1 and k != "classes"}
    ref = _map_state(metric, device, range(n_batches))
    out["map_items_equal"] = all(
        len(synced[k]) == len(ref[k]) and all(torch.equal(a, b.cpu()) for a, b in zip(synced[k], ref[k]))
        for k in ref if k != "_n"
    )
    if rank == 0:  # the single-process value, once, under the profiler: the matcher's device time
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=activities) as prof:
            ref_value = metric.compute_state(ref)
            torch.cuda.synchronize()
        out["map_ref_compute_s"] = time.perf_counter() - t0
        out["map_ref"] = {k: float(v) for k, v in ref_value.items() if v.numel() == 1 and k != "classes"}
        out["map_ref_device_s"] = _device_s(prof)
        out["map_ref_coco_match_s"] = _device_s(prof, "coco_match")
        out["map_ref_top_ops"] = _top_device_ops(prof)
        out["map_ref_coco_match_kernels"] = sum(
            1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and "coco_match" in e.name
        )
    return out


def worker_main(args) -> int:
    """One rank of a phase-5 or phase-6 world: ``--worker sync|ragged``."""
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    device = torch.device("cuda", args.rank if args.backend == "nccl" else 0)
    torch.cuda.set_device(device)
    dist.init_process_group(args.backend, init_method=args.init, rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S - 60))
    try:
        if args.worker == "sync":
            result = worker_sync(args.rank, args.world, device)
        else:
            result = worker_ragged(args.rank, args.world, device)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(result, f)
    return 0


def run_world(phase: str, backend: str, world: int) -> list:
    """Run ``world`` ranks of ``phase`` in processes of their own; their results in rank order."""
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_{backend}_")
    procs = []
    for rank in range(world):
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", phase, "--backend", backend,
               "--rank", str(rank), "--world", str(world), "--init", f"file://{tmp}/rendezvous",
               "--out", f"{tmp}/rank{rank}.json"]
        log = open(f"{tmp}/rank{rank}.log", "w")
        procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    failed = []
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {rank} did not finish within {WORLD_TIMEOUT_S} s")
                break
            if proc.returncode:
                failed.append(f"rank {rank} exited {proc.returncode}")
    finally:
        for proc, log in procs:  # stop every rank, whatever happened
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        for rank in range(world):
            with open(f"{tmp}/rank{rank}.log") as f:
                print(f"--- {phase} {backend} rank {rank}:\n{f.read()[-3000:]}", file=sys.stderr)
        check(False, f"{phase} world ({backend} x{world}): " + "; ".join(failed))
    results = []
    for rank in range(world):
        with open(f"{tmp}/rank{rank}.json") as f:
            results.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    return results


def _worlds() -> list:
    """NCCL with one rank per card, and gloo with 4 ranks on card 0 (CUDA tensors)."""
    return [("nccl", torch.cuda.device_count()), ("gloo", 4)]


def phase_sync() -> dict:
    record = {}
    for backend, world in _worlds():
        results = run_world("sync", backend, world)
        label = f"{backend} x{world}"
        rows = [r["rows"] for r in results]
        check(sum(rows) == N_SAMPLES, f"[{label}] the ranks hold {rows} rows, not {N_SAMPLES} in all")
        check(results[-1]["rows"] % BATCH == N_SAMPLES % BATCH, f"[{label}] the 848-row batch is not on the last rank")
        first = results[0]
        for r in results:
            tag = f"[{label}] rank {r['rank']}"
            check(r["leaves_equal"], f"{tag}: the synced states differ from the single-process run")
            check(r["ap_rows"] == N_SAMPLES, f"{tag}: the AP cat state has {r['ap_rows']} rows")
            check(set(r["n"].values()) == {-(-N_SAMPLES // BATCH)}, f"{tag}: synced update counts {r['n']}")
            check(r["launches"]["binned_confmat_multiclass"] == r["batches"],
                  f"{tag}: binned_confmat_multiclass launched {r['launches']} times for {r['batches']} batches")
            for k, v in r["values"].items():
                check(math.isfinite(v), f"{tag}: {k} = {v}")
                tol = 1e-6 if k == "ap" else 0.0
                check(abs(v - r["ref_values"][k]) <= tol, f"{tag}: {k} {v} vs single-process {r['ref_values'][k]}")
                check(v == first["values"][k], f"{tag}: {k} differs from rank 0")
        for r in results:
            tag = f"[{label}] rank {r['rank']}, second collection"
            check(all(r["col2_equal"].values()), f"{tag}: differs from the single-process run: {r['col2_equal']}")
            check(r["col2_cat_rows"] == N_SAMPLES and r["col2_pearson_n"] == N_SAMPLES, f"{tag}: rows")
        print(f"[sync] {label}: second collection (mean, sum, max, cat, R2, Pearson by its own sync): sync "
              f"{[round(r['col2_sync_ms'], 3) for r in results]} ms; values {first['col2_values']} equal the "
              f"single-process run on every rank (max and cat exactly, the rest within rtol {SYNC2_RTOL})")
        print(f"[sync] {label}: rows per rank {rows}; collectives {first['collectives']} "
              f"(one all_reduce a bucket: {first['bucket_bytes']} bytes; AP's cat leaves gathered: "
              f"{first['gathered_bytes']} bytes on every rank); sync {[round(r['sync_ms'], 3) for r in results]} ms, "
              f"updates {[round(r['update_s'], 4) for r in results]} s, compute {[round(r['compute_ms'], 3) for r in results]} ms; "
              f"values {first['values']} equal the single-process run")
        record[label] = results
    return record


def phase_ragged(chunk_shapes: collections.Counter) -> dict:
    record = {}
    for backend, world in _worlds():
        results = run_world("ragged", backend, world)
        label = f"{backend} x{world}"
        first = results[0]
        n_batches = -(-MAP_IMAGES // MAP_BATCH)
        rouge_counts = [len(b) for b in _rank_blocks(ROUGE_PAIRS // ROUGE_BATCH, world, True)]
        for r in results:
            tag = f"[{label}] rank {r['rank']}"
            check(r["rouge_items"] == [ROUGE_BATCH] * sum(rouge_counts), f"{tag}: ROUGE items {r['rouge_items']}")
            check(r["rouge_items_equal"] and r["map_items_equal"], f"{tag}: synced items differ from the single process")
            for k, v in r["rouge"].items():
                check(abs(v - r["rouge_ref"][k]) <= 1e-6, f"{tag}: {k} {v} vs single-process {r['rouge_ref'][k]}")
            check(r["map_items"] == MAP_IMAGES, f"{tag}: {r['map_items']} images after the sync, expected {MAP_IMAGES}")
            check(r["map"] == first["map"], f"{tag}: mAP differs from rank 0")
            check(r["launches"]["coco_match"] > 0, f"{tag}: coco_match never launched")
            shapes = collections.Counter({tuple(shape): n for shape, n in r["shapes"]})
            check(shapes == chunk_shapes, f"{tag}: coco_match launched at {dict(shapes)}, phase 3 checked {dict(chunk_shapes)}")
        check(first["map"] == first["map_ref"], f"[{label}] mAP {first['map']} vs single-process {first['map_ref']}")
        check(0.0 < first["map"]["map"] < 1.0, f"[{label}] mAP {first['map']['map']}")
        images = [r["images"] for r in results]
        check(sum(images) == MAP_IMAGES and (world == 1 or len(set(images)) == world), f"[{label}] images per rank {images}")
        check(first["map_ref_coco_match_kernels"] == sum(chunk_shapes.values()),
              f"[{label}] the profiler saw {first['map_ref_coco_match_kernels']} coco_match kernels")
        print(f"[ragged] {label}: ROUGE updates per rank {rouge_counts}, sync {[round(r['rouge_sync_ms'], 3) for r in results]} ms, "
              f"{first['rouge']}; mAP images per rank {images} ({n_batches} batches of {MAP_BATCH}), sync "
              f"{[round(r['map_sync_ms'], 3) for r in results]} ms, collectives {first['map_collectives']}, compute "
              f"{[round(r['map_compute_s'], 3) for r in results]} s; coco_match launches "
              f"{[r['launches']['coco_match'] for r in results]} at the chunks phase 3 checked; single process on rank 0 "
              f"under the profiler: {first['map_ref_compute_s']:.3f} s, device {first['map_ref_device_s']:.6f} s, of which "
              f"coco_match {first['map_ref_coco_match_s']:.6f} s in {first['map_ref_coco_match_kernels']} kernels; "
              f"map {first['map']['map']:.6f}, "
              f"map_50 {first['map']['map_50']:.6f}: equal to the single-process run")
        for name, sec, count in first["map_ref_top_ops"]:
            print(f"[ragged] {label}: single-process mAP compute, device operation {name}: {sec:.6f} s in {count}")
        record[label] = results
    return record


# ------------------------------------------------------ phase 7: the classification tower
SEG_IMAGES = 24  # of Cityscapes val's 500, cut for the run's time
COCO_ML_IMAGES, COCO_ML_LABELS, COCO_ML_BATCH = 40_504, 80, 256  # MS-COCO 2014 val, its 80 labels
CPU_RERUN_BATCHES = 4


def _grouped(make, first_batch):
    """``make(device, compute_groups)`` built twice on the card: once with automatic
    compute groups, updated with the first batch to form them, then with those groups
    given, so that every batch, the first too, runs one update a group."""
    probe = make("cuda", True)
    probe.update(*first_batch)
    groups = [list(members) for members in probe.compute_groups.values()]
    return make("cuda", groups), groups


def _states_of(collection, extra=()) -> dict:
    """Copies of every leaf of every member's state (and of ``extra`` metrics')."""
    out = {}
    for name, metric in list(collection.items(keep_base=True)) + list(extra):
        for leaf, value in metric.metric_state.items():
            out[f"{name}.{leaf}"] = tuple(v.clone() for v in value) if isinstance(value, tuple) else value.clone()
    return out


def _check_cpu_rerun(leg: str, card: dict, cpu: dict) -> int:
    """The card's integer states after the first batches equal the CPU path's; returns the leaves compared."""
    check(card.keys() == cpu.keys(), f"[tower {leg}] leaves {sorted(card)} vs {sorted(cpu)}")
    compared = 0
    for key, want in cpu.items():
        got = card[key]
        pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
        for g, w in pairs:
            check(g.dtype == w.dtype, f"[tower {leg}] {key} dtype {g.dtype} vs {w.dtype}")
            if w.dtype == torch.int32:
                check(torch.equal(g.cpu(), w), f"[tower {leg}] {key} differs between the card and the CPU")
                compared += 1
    return compared


def _run_leg(leg, make, batches, extra=None):
    """Drive ``batches()`` (a generator of card batches) through the grouped collection
    (and ``extra``, a metric outside it); the first batches again on the CPU path."""
    from torchmetrics_tpu_torch.kernels.confmat import confmat_multiclass

    batch_iter = batches()
    first = next(batch_iter)
    col, groups = _grouped(make, first)
    extra_card = extra("cuda") if extra else None
    times, extra_times, early = [], [], None
    confmat_multiclass.launches = 0
    torch.cuda.synchronize()
    t_leg = time.perf_counter()
    for i, batch in enumerate(b for it in ([first], batch_iter) for b in it):
        t0 = time.perf_counter()
        col.update(*batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if extra_card is not None:
            t0 = time.perf_counter()
            extra_card.update(*batch)
            torch.cuda.synchronize()
            extra_times.append((time.perf_counter() - t0) * 1e3)
        if i + 1 == CPU_RERUN_BATCHES:
            early = _states_of(col, [("extra", extra_card.metric_b)] if extra_card is not None else [])
    n_batches = i + 1
    values = col.compute()
    extra_value = extra_card.compute() if extra_card is not None else None
    torch.cuda.synchronize()
    leg_s = time.perf_counter() - t_leg
    launches = confmat_multiclass.launches

    cpu_col = make("cpu", groups)
    cpu_extra = extra("cpu") if extra else None
    for batch in (b for _, b in zip(range(CPU_RERUN_BATCHES), batches())):
        cpu_batch = [x.cpu() for x in batch]
        cpu_col.update(*cpu_batch)
        if cpu_extra is not None:
            cpu_extra.update(*cpu_batch)
    compared = _check_cpu_rerun(leg, early, _states_of(cpu_col, [("extra", cpu_extra.metric_b)] if cpu_extra else []))
    return {
        "batches": n_batches, "groups": groups, "launches": launches, "leg_s": leg_s,
        "update_ms_median": statistics.median(times),
        "extra_update_ms_median": statistics.median(extra_times) if extra_times else None,
        "values": {k: v.tolist() if v.numel() <= 4 else f"{tuple(v.shape)} {str(v.dtype)[6:]}" for k, v in values.items()},
        "tensors": values, "extra_value": None if extra_value is None else float(extra_value),
        "cpu_leaves_equal": compared,
    }


def _tower_imagenet(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"num_classes": N_CLASSES, "device": device}
    return MetricCollection({
        "confmat": tc.MulticlassConfusionMatrix(**kw), "kappa": tc.MulticlassCohenKappa(**kw),
        "mcc": tc.MulticlassMatthewsCorrCoef(**kw), "jaccard": tc.MulticlassJaccardIndex(average="macro", **kw),
        "precision": tc.MulticlassPrecision(average="macro", **kw), "recall": tc.MulticlassRecall(average="macro", **kw),
        "specificity": tc.MulticlassSpecificity(average="macro", **kw),
    }, compute_groups=compute_groups)


def _top1_error(device):
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy

    return 1 - MulticlassAccuracy(num_classes=N_CLASSES, average="micro", device=device)


def _tower_cityscapes(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"num_classes": SEG_SHAPE[1], "ignore_index": SEG_IGNORE, "device": device}
    return MetricCollection({"miou": tc.MulticlassJaccardIndex(**kw), "confmat": tc.MulticlassConfusionMatrix(**kw)},
                            compute_groups=compute_groups)


def _tower_coco(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"num_labels": COCO_ML_LABELS, "device": device}
    return MetricCollection({
        "accuracy": tc.MultilabelAccuracy(**kw), "f1": tc.MultilabelF1Score(average="macro", **kw),
        "precision": tc.MultilabelPrecision(**kw), "recall": tc.MultilabelRecall(**kw),
        "hamming": tc.MultilabelHammingDistance(**kw), "confmat": tc.MultilabelConfusionMatrix(**kw),
        "jaccard": tc.MultilabelJaccardIndex(**kw), "mcc": tc.MultilabelMatthewsCorrCoef(**kw),
    }, compute_groups=compute_groups)


def _tower_binary(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "accuracy": tc.BinaryAccuracy(device=device), "f1": tc.BinaryF1Score(device=device),
        "kappa": tc.BinaryCohenKappa(device=device), "jaccard": tc.BinaryJaccardIndex(device=device),
        "confmat": tc.BinaryConfusionMatrix(device=device),
    }, compute_groups=compute_groups)


def _coco_multilabel_data(gen: torch.Generator):
    """MS-COCO 2014 val's shape: 40,504 images x 80 labels, about 2.9 labels an
    image; sigmoid scores of a classifier that separates them, on the card."""
    dev = torch.device("cuda")
    target = (torch.rand((COCO_ML_IMAGES, COCO_ML_LABELS), generator=gen, device=dev) < 2.9 / COCO_ML_LABELS)
    logits = 1.5 * torch.randn((COCO_ML_IMAGES, COCO_ML_LABELS), generator=gen, device=dev) + 4.0 * target - 2.0
    return torch.sigmoid(logits), target.to(torch.int32)


def phase_tower() -> dict:
    """Phase 7: the classification tower on one card, no sync. (i) the ImageNet-1k set
    through the confusion-matrix family and the stat scores, and the top-1 error
    composite; (ii) Cityscapes-shaped segmentation; (iii) COCO-shaped multilabel;
    (iv) binary selective prediction over (i)'s scores."""
    from torchmetrics_tpu_torch.kernels.confmat import confmat_multiclass

    record = {}
    probs, target, _, _ = _main_path_data(torch.Generator(device="cuda").manual_seed(SEED))
    imagenet = lambda: ((probs[s:s + BATCH], target[s:s + BATCH]) for s in range(0, N_SAMPLES, BATCH))  # noqa: E731
    leg = _run_leg("imagenet", _tower_imagenet, imagenet, extra=_top1_error)
    n = leg["batches"]
    grouped = next(g for g in leg["groups"] if "confmat" in g)
    check(sorted(grouped)[:4] == ["confmat", "jaccard", "kappa", "mcc"] and len(grouped) == 4,
          f"[tower imagenet] the confusion-matrix metrics did not merge into one group: {leg['groups']}")
    check(leg["launches"] == n == -(-N_SAMPLES // BATCH),
          f"[tower imagenet] confmat_multiclass launched {leg['launches']} times for {n} batches")
    confmat = leg["tensors"]["confmat"]
    check(int(confmat.sum()) == N_SAMPLES and confmat.dtype == torch.int32, "[tower imagenet] confmat counts")
    top1 = 1.0 - float(confmat.diagonal().sum()) / N_SAMPLES
    check(abs(leg["extra_value"] - top1) <= 1e-6, f"[tower imagenet] top-1 error {leg['extra_value']} vs {top1}")
    for k in ("kappa", "mcc", "jaccard", "precision", "recall", "specificity"):
        v = leg["tensors"][k]
        check(v.shape == () and bool(torch.isfinite(v)) and 0.0 < float(v) <= 1.0, f"[tower imagenet] {k} = {v}")
    record["imagenet"] = leg
    del probs, target

    def cityscapes():
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        return (_seg_batch(gen) for _ in range(SEG_IMAGES // SEG_SHAPE[0]))

    leg = _run_leg("cityscapes", _tower_cityscapes, cityscapes)
    check(leg["groups"] == [["miou", "confmat"]] or leg["groups"] == [["confmat", "miou"]],
          f"[tower cityscapes] groups {leg['groups']}")
    check(leg["launches"] == leg["batches"] == SEG_IMAGES // SEG_SHAPE[0],
          f"[tower cityscapes] confmat_multiclass launched {leg['launches']} times for {leg['batches']} batches")
    pixels = int(leg["tensors"]["confmat"].sum())
    total = SEG_IMAGES * SEG_SHAPE[2] * SEG_SHAPE[3]
    check(0.93 * total < pixels < 0.97 * total, f"[tower cityscapes] {pixels} of {total} pixels counted (~5 % void)")
    check(0.0 < float(leg["tensors"]["miou"]) < 1.0, f"[tower cityscapes] mIoU {leg['tensors']['miou']}")
    record["cityscapes"] = leg

    scores, labels = _coco_multilabel_data(torch.Generator(device="cuda").manual_seed(SEED + 6))
    coco = lambda: ((scores[s:s + COCO_ML_BATCH], labels[s:s + COCO_ML_BATCH])  # noqa: E731
                    for s in range(0, COCO_ML_IMAGES, COCO_ML_BATCH))
    leg = _run_leg("coco", _tower_coco, coco)
    check(leg["launches"] == 0, "[tower coco] the multilabel path launched confmat_multiclass")
    check(int(leg["tensors"]["confmat"].sum()) == COCO_ML_IMAGES * COCO_ML_LABELS, "[tower coco] confmat counts")
    for k, v in leg["tensors"].items():
        check(bool(torch.isfinite(v.float()).all()), f"[tower coco] {k} = {v}")
    record["coco"] = leg
    del scores, labels

    probs, target, _, _ = _main_path_data(torch.Generator(device="cuda").manual_seed(SEED))
    conf, pred = probs.max(1)
    correct = (pred == target).to(torch.int32)
    del probs
    binary = lambda: ((conf[s:s + BATCH], correct[s:s + BATCH]) for s in range(0, N_SAMPLES, BATCH))  # noqa: E731
    leg = _run_leg("binary", _tower_binary, binary)
    check(leg["launches"] == 0, "[tower binary] the binary path launched confmat_multiclass")
    cm = leg["tensors"]["confmat"]
    check(int(cm.sum()) == N_SAMPLES and int(cm[1].sum()) == int(correct.sum()), "[tower binary] confmat counts")
    record["binary"] = leg

    for name, leg in record.items():
        extra = "" if leg["extra_update_ms_median"] is None else \
            f"; top1_error = 1 - MulticlassAccuracy: update median {leg['extra_update_ms_median']:.4f} ms, " \
            f"value {leg['extra_value']:.6f}"
        print(f"[tower] {name}: {leg['batches']} batches in {leg['leg_s']:.3f} s; compute groups {leg['groups']}; "
              f"collection update median {leg['update_ms_median']:.4f} ms (host clock, a synchronize after each "
              f"update){extra}; confmat_multiclass launches {leg['launches']}; first {CPU_RERUN_BATCHES} batches "
              f"equal on the CPU path ({leg['cpu_leaves_equal']} int32 leaves); values {leg['values']}")
        del leg["tensors"]
    print(f"[tower] cityscapes: {SEG_IMAGES} images of the val set's 500 (cut for the run's time), "
          f"{SEG_IMAGES // SEG_SHAPE[0]} batches of {SEG_SHAPE}")
    return record


# ------------------------------------ phase 8: the curve family, aggregation and regression
DEPTH_MAPS, DEPTH_HW, DEPTH_BATCH = 654, (480, 640), 8  # NYU Depth V2's labelled test split: 654 maps of 480 x 640
OTHER_ROWS, OTHER_BATCH = 10_000, 2_500
# float states and values, the card against the CPU path (sums of up to ~10 M float32 terms in another order)
FLOAT_RTOL, FLOAT_ATOL = 1e-4, 1e-5


def _copy(value):
    if isinstance(value, dict):
        return {k: _copy(v) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(_copy(v) for v in value)
    return value.clone()


def _snapshot(col) -> dict:
    """Copies of every member's state."""
    return {name: _copy(m.metric_state) for name, m in col.items(keep_base=True)}


def _cpu(x):
    return x.cpu() if isinstance(x, torch.Tensor) else x


def _assert_same(tag: str, got, want, rtol: float = FLOAT_RTOL, atol: float = FLOAT_ATOL) -> int:
    """``got`` (the card) against ``want`` (the CPU path): integer tensors equal, float ones
    within ``rtol`` / ``atol`` (NaNs in place); returns the tensors compared."""
    if isinstance(want, dict):
        check(set(got) == set(want), f"{tag}: keys {sorted(got)} vs {sorted(want)}")
        return sum(_assert_same(f"{tag}.{k}", got[k], want[k], rtol, atol) for k in want)
    if isinstance(want, (tuple, list)):
        check(len(got) == len(want), f"{tag}: {len(got)} items vs {len(want)}")
        return sum(_assert_same(f"{tag}[{i}]", g, w, rtol, atol) for i, (g, w) in enumerate(zip(got, want)))
    got = got.cpu()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{tag}: {got.dtype} {tuple(got.shape)} vs {want.dtype} {tuple(want.shape)}")
    if not want.dtype.is_floating_point:
        check(torch.equal(got, want), f"{tag} differs between the card and the CPU")
    else:
        try:
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol, equal_nan=True)
        except AssertionError as err:
            check(False, f"{tag}: card and CPU differ: {err}")
    return 1


def _value_summary(value):
    if isinstance(value, (tuple, list)):
        return [_value_summary(v) for v in value[:3]] + ([f"... {len(value)} items"] if len(value) > 3 else [])
    return value.tolist() if value.numel() <= 4 else f"{tuple(value.shape)} {str(value.dtype)[6:]}"


def _curve_leg(leg, make, batches, kernels, rtol: float = FLOAT_RTOL, atol: float = FLOAT_ATOL,
               state_checks=None) -> dict:
    """Drive ``batches()`` (``(args, kwargs)`` of card tensors) through ``make("cuda", groups)``,
    the compute groups formed on the first batch by a probe collection, so that every batch
    runs one update a group; the launches of ``kernels`` are counted from 0 over this run
    only. The first batches run again on the CPU path: the states and the values after them
    must match. ``state_checks`` (``{member name prefix: check(tag, card state, CPU state)}``)
    holds those members' states instead, and their values against the CPU path's compute of
    the card's state."""
    batch_iter = batches()
    first = next(batch_iter)
    probe = make("cuda", True)
    probe.update(*first[0], **first[1])
    groups = [list(members) for members in probe.compute_groups.values()]
    del probe
    col = make("cuda", groups)
    times, early = [], None
    for kernel in kernels:
        kernel.launches = 0
    torch.cuda.synchronize()
    t_leg = time.perf_counter()
    for i, (args, kwargs) in enumerate(b for it in ([first], batch_iter) for b in it):
        t0 = time.perf_counter()
        col.update(*args, **kwargs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if i + 1 == CPU_RERUN_BATCHES:
            early = _snapshot(col)
    t0 = time.perf_counter()
    values = col.compute()
    torch.cuda.synchronize()
    compute_ms = (time.perf_counter() - t0) * 1e3
    leg_s = time.perf_counter() - t_leg
    launches = {k.__name__: k.launches for k in kernels}

    cpu_col = make("cpu", groups)
    for args, kwargs in (b for _, b in zip(range(CPU_RERUN_BATCHES), batches())):
        cpu_col.update(*map(_cpu, args), **{k: _cpu(v) for k, v in kwargs.items()})
    cpu_states = _snapshot(cpu_col)
    cpu_values = {name: m.compute() for name, m in cpu_col.items(keep_base=True)}
    compared = 0
    for name in early:
        tag = f"[{leg}] {name} after {CPU_RERUN_BATCHES} batches"
        state_check = next((v for k, v in (state_checks or {}).items() if name.startswith(k)), None)
        if state_check is None:
            compared += _assert_same(f"{tag}: state", early[name], cpu_states[name], rtol, atol)
            want = cpu_values[name]
        else:
            state_check(f"{tag}: state", early[name], cpu_states[name])
            compared += len(early[name])
            want = cpu_col[name].compute_state({k: _cpu(v) for k, v in early[name].items()})
        compared += _assert_same(f"{tag}: value", col[name].compute_state(early[name]), want, rtol, atol)
    return {
        "batches": i + 1, "groups": groups, "launches": launches, "leg_s": leg_s,
        "update_ms_median": statistics.median(times), "compute_ms": compute_ms,
        "values": {k: _value_summary(v) for k, v in values.items()}, "tensors": values, "cpu_compared": compared,
    }


def _curves_imagenet(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"num_classes": N_CLASSES, "thresholds": None, "device": device}
    return MetricCollection({"auroc": tc.MulticlassAUROC(average="macro", **kw), "roc": tc.MulticlassROC(**kw)},
                            compute_groups=compute_groups)


def _curves_coco(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"num_labels": COCO_ML_LABELS, "device": device}
    return MetricCollection({
        "auroc": tc.MultilabelAUROC(thresholds=ML_THRESHOLDS, **kw),
        "ap": tc.MultilabelAveragePrecision(thresholds=ML_THRESHOLDS, **kw),
        "prc": tc.MultilabelPrecisionRecallCurve(thresholds=ML_THRESHOLDS, **kw),
        "ap_exact": tc.MultilabelAveragePrecision(thresholds=None, **kw),
    }, compute_groups=compute_groups)


def _curves_binary(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "auroc": tc.BinaryAUROC(thresholds=None, device=device),
        "auroc_fpr05": tc.BinaryAUROC(thresholds=None, max_fpr=0.05, device=device),
        "auroc_200": tc.BinaryAUROC(thresholds=BIN_THRESHOLDS, device=device),
        "ap": tc.BinaryAveragePrecision(thresholds=None, device=device),
        "roc": tc.BinaryROC(thresholds=None, device=device),
    }, compute_groups=compute_groups)


def _curves_depth(device, compute_groups):
    from torchmetrics_tpu_torch import aggregation as agg, regression as reg
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "mae": reg.MeanAbsoluteError(device=device), "rmse": reg.MeanSquaredError(squared=False, device=device),
        "msle": reg.MeanSquaredLogError(device=device), "mape": reg.MeanAbsolutePercentageError(device=device),
        "r2": reg.R2Score(device=device), "explained_variance": reg.ExplainedVariance(device=device),
        "pearson": reg.PearsonCorrCoef(device=device),
        "loss_mean": agg.MeanMetric(device=device), "loss_max": agg.MaxMetric(device=device),
        "loss_running": agg.RunningMean(window=10, device=device),
    }, compute_groups=compute_groups)


def _depth_data(gen: torch.Generator):
    """NYU Depth V2's labelled test split's shape on the card: 654 float32 depth maps of
    480 x 640, seeded in 0.5-10 m, and predictions with ~10 % relative and 5 cm absolute
    seeded error (at least 1 cm)."""
    dev = torch.device("cuda")
    target = 0.5 + 9.5 * torch.rand((DEPTH_MAPS, *DEPTH_HW), generator=gen, device=dev)
    noise = torch.randn((DEPTH_MAPS, *DEPTH_HW), generator=gen, device=dev)
    preds = target * (1.0 + 0.1 * noise)
    noise.normal_(generator=gen)
    preds = torch.clamp(preds + 0.05 * noise, min=0.01)
    del noise
    return preds, target


def _other_metrics(device) -> dict:
    """Every other new class of the slice: ``{name: (metric, input kind)}``."""
    from torchmetrics_tpu_torch import aggregation as agg, regression as reg

    kw = {"device": device}
    return {
        "sum": (agg.SumMetric(**kw), "value"), "min": (agg.MinMetric(**kw), "value"),
        "cat": (agg.CatMetric(**kw), "value"), "running_sum": (agg.RunningSum(window=3, **kw), "value"),
        "concordance": (reg.ConcordanceCorrCoef(**kw), "pair"), "spearman": (reg.SpearmanCorrCoef(**kw), "pair"),
        "kendall": (reg.KendallRankCorrCoef(**kw), "pair"),
        "smape": (reg.SymmetricMeanAbsolutePercentageError(**kw), "pair"),
        "wmape": (reg.WeightedMeanAbsolutePercentageError(**kw), "pair"),
        "log_cosh": (reg.LogCoshError(**kw), "pair"), "minkowski": (reg.MinkowskiDistance(p=3.0, **kw), "pair"),
        "tweedie": (reg.TweedieDevianceScore(power=1.5, **kw), "positive"),
        "csi": (reg.CriticalSuccessIndex(threshold=0.5, **kw), "pair"),
        "rse": (reg.RelativeSquaredError(**kw), "pair"), "kl": (reg.KLDivergence(**kw), "distribution"),
        "cosine": (reg.CosineSimilarity(reduction="mean", **kw), "vectors"),
    }


def _other_data(gen: torch.Generator) -> dict:
    dev = torch.device("cuda")
    x = torch.randn((OTHER_ROWS,), generator=gen, device=dev)
    y = x + 0.3 * torch.randn((OTHER_ROWS,), generator=gen, device=dev)
    v = torch.randn((OTHER_ROWS, 8), generator=gen, device=dev)
    return {
        "value": (10.0 * x,), "pair": (x, y), "positive": (x.abs() + 0.1, y.abs() + 0.1),
        "distribution": (torch.softmax(v, 1), torch.softmax(v + 0.5 * torch.randn_like(v), 1)),
        "vectors": (v, v + 0.3 * torch.randn((OTHER_ROWS, 8), generator=gen, device=dev)),
    }


def phase_curves() -> dict:
    """Phase 8 on one card, no sync: (i) the exact multiclass AUROC and ROC over the
    ImageNet-1k set; (ii) the COCO-shaped multilabel curves, binned and exact; (iii) the
    binary curves over the selective-prediction rows; (iv) dense depth regression with
    the loss aggregators; then every other new class over a 10,000-row set."""
    from torchmetrics_tpu_torch.kernels.binned_confmat import binned_confmat_multiclass, binned_confmat_multilabel

    kernels = (binned_confmat_multiclass, binned_confmat_multilabel)
    n_batches = -(-N_SAMPLES // BATCH)
    record = {}
    probs, target, _, _ = _main_path_data(torch.Generator(device="cuda").manual_seed(SEED))
    imagenet = lambda: (((probs[s:s + BATCH], target[s:s + BATCH]), {}) for s in range(0, N_SAMPLES, BATCH))  # noqa: E731
    leg = _curve_leg("imagenet", _curves_imagenet, imagenet, kernels)
    check(leg["groups"] in ([["auroc", "roc"]], [["roc", "auroc"]]), f"[curves imagenet] groups {leg['groups']}")
    check(leg["launches"] == {"binned_confmat_multiclass": 0, "binned_confmat_multilabel": 0},
          f"[curves imagenet] the exact path launched {leg['launches']}")
    auroc, (fprs, tprs, thrs) = leg["tensors"]["auroc"], leg["tensors"]["roc"]
    check(auroc.shape == () and 0.5 < float(auroc) < 1.0, f"[curves imagenet] AUROC {auroc}")
    check(len(fprs) == len(tprs) == len(thrs) == N_CLASSES, "[curves imagenet] ROC curves a class")
    check(all(f.shape == (N_SAMPLES + 1,) and float(f[-1]) == 1.0 and float(t[-1]) == 1.0 for f, t in zip(fprs, tprs)),
          "[curves imagenet] every ROC curve runs from (0, 0) to (1, 1) over 50,001 points")
    record["imagenet"] = leg
    del imagenet

    scores, labels = _coco_multilabel_data(torch.Generator(device="cuda").manual_seed(SEED + 6))
    coco = lambda: (((scores[s:s + COCO_ML_BATCH], labels[s:s + COCO_ML_BATCH]), {})  # noqa: E731
                    for s in range(0, COCO_ML_IMAGES, COCO_ML_BATCH))
    leg = _curve_leg("coco", _curves_coco, coco, kernels)
    coco_batches = -(-COCO_ML_IMAGES // COCO_ML_BATCH)
    check(sorted(map(sorted, leg["groups"])) == [["ap", "auroc", "prc"], ["ap_exact"]], f"[curves coco] groups {leg['groups']}")
    check(leg["launches"] == {"binned_confmat_multiclass": 0, "binned_confmat_multilabel": coco_batches},
          f"[curves coco] launches {leg['launches']}, expected {coco_batches} binned_confmat_multilabel")
    for k in ("auroc", "ap", "ap_exact"):
        v = leg["tensors"][k]
        check(v.shape == () and 0.5 < float(v) <= 1.0, f"[curves coco] {k} = {v}")
    check(abs(float(leg["tensors"]["ap"]) - float(leg["tensors"]["ap_exact"])) < 0.03,
          f"[curves coco] binned AP {leg['tensors']['ap']} far from the exact {leg['tensors']['ap_exact']}")
    check(leg["tensors"]["prc"][0].shape == (COCO_ML_LABELS, ML_THRESHOLDS + 1), "[curves coco] PR curve shape")
    record["coco"] = leg
    del scores, labels, coco

    conf, pred = probs.max(1)
    correct = (pred == target).to(torch.int32)
    del probs, target
    binary = lambda: (((conf[s:s + BATCH], correct[s:s + BATCH]), {}) for s in range(0, N_SAMPLES, BATCH))  # noqa: E731
    leg = _curve_leg("binary", _curves_binary, binary, kernels)
    check(sorted(map(sorted, leg["groups"])) == [["ap", "auroc", "auroc_fpr05", "roc"], ["auroc_200"]],
          f"[curves binary] groups {leg['groups']}")
    check(leg["launches"] == {"binned_confmat_multiclass": 0, "binned_confmat_multilabel": n_batches},
          f"[curves binary] launches {leg['launches']}, expected {n_batches} binned_confmat_multilabel")
    t = leg["tensors"]
    check(abs(float(t["auroc"]) - float(t["auroc_200"])) < 0.03, f"[curves binary] AUROC {t['auroc']} vs binned {t['auroc_200']}")
    check(0.5 <= float(t["auroc_fpr05"]) <= 1.0, f"[curves binary] partial AUROC {t['auroc_fpr05']}")
    check(t["roc"][0].shape == (N_SAMPLES + 1,), "[curves binary] ROC points")
    record["binary"] = leg
    del conf, correct, binary

    preds, depth = _depth_data(torch.Generator(device="cuda").manual_seed(SEED + 8))

    def depth_batches():
        for s in range(0, DEPTH_MAPS, DEPTH_BATCH):
            p, t = preds[s:s + DEPTH_BATCH], depth[s:s + DEPTH_BATCH]
            loss = (p - t).abs().mean()  # the eval loop's per-batch L1 loss
            yield (), {"preds": p.reshape(-1), "target": t.reshape(-1), "value": loss}

    leg = _curve_leg("depth", _curves_depth, depth_batches, kernels)
    check(leg["launches"] == {"binned_confmat_multiclass": 0, "binned_confmat_multilabel": 0},
          f"[curves depth] launches {leg['launches']}")
    check(leg["batches"] == -(-DEPTH_MAPS // DEPTH_BATCH), f"[curves depth] {leg['batches']} batches")
    losses = torch.stack([kw["value"] for _, kw in depth_batches()])
    t = leg["tensors"]
    check(abs(float(t["loss_mean"]) - float(losses.mean())) <= 1e-5 * float(losses.mean()), "[curves depth] mean loss")
    check(float(t["loss_max"]) == float(losses.max()), "[curves depth] max loss")
    check(abs(float(t["loss_running"]) - float(losses[-10:].mean())) <= 1e-5 * float(losses.mean()),
          "[curves depth] running mean of the last 10 losses")
    check(0.0 < float(t["r2"]) < 1.0 and 0.0 < float(t["pearson"]) < 1.0, f"[curves depth] R2 {t['r2']}, r {t['pearson']}")
    for k, v in t.items():
        check(bool(torch.isfinite(v).all()), f"[curves depth] {k} = {v}")
    record["depth"] = leg
    del preds, depth

    # every other new class: the card against the CPU path over one seeded set
    data = _other_data(torch.Generator(device="cuda").manual_seed(SEED + 9))
    card, cpu = _other_metrics("cuda"), _other_metrics("cpu")
    others, t0 = {}, time.perf_counter()
    for name, (metric, kind) in card.items():
        for s in range(0, OTHER_ROWS, OTHER_BATCH):
            args = [x[s:s + OTHER_BATCH] for x in data[kind]]
            metric.update(*args)
            cpu[name][0].update(*(a.cpu() for a in args))
        value = metric.compute()
        _assert_same(f"[curves others] {name}", value, cpu[name][0].compute())
        _assert_same(f"[curves others] {name} state", metric.metric_state, cpu[name][0].metric_state)
        others[name] = _value_summary(value)
    record["others"] = {"values": others, "s": time.perf_counter() - t0}

    for name, leg in record.items():
        if name == "others":
            continue
        print(f"[curves] {name}: {leg['batches']} batches in {leg['leg_s']:.3f} s; compute groups {leg['groups']}; "
              f"collection update median {leg['update_ms_median']:.4f} ms (host clock, a synchronize after each), "
              f"compute {leg['compute_ms']:.4f} ms; launches {leg['launches']}; first {CPU_RERUN_BATCHES} batches "
              f"match the CPU path ({leg['cpu_compared']} tensors: integers equal, floats within rtol {FLOAT_RTOL}, "
              f"atol {FLOAT_ATOL}); values {leg['values']}")
        del leg["tensors"]
    print(f"[curves] others: {len(others)} classes over {OTHER_ROWS} seeded rows on the card equal the CPU path "
          f"(rtol {FLOAT_RTOL}, atol {FLOAT_ATOL}) in {record['others']['s']:.2f} s: {others}")
    return record


# ------------------------------------------ phase 9: the rest of classification
CELEBA_ROWS = 19_962  # the CelebA test split
# the card against the CPU path: float states and values within 1e-5 relative
REST_RTOL, REST_ATOL = 1e-5, 1e-6


def _rest_imagenet(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"num_classes": N_CLASSES, "device": device}
    return MetricCollection({
        "ece_l1": tc.MulticlassCalibrationError(n_bins=CE_BINS, norm="l1", **kw),
        "ece_l2": tc.MulticlassCalibrationError(n_bins=CE_BINS, norm="l2", **kw),
        "ece_max": tc.MulticlassCalibrationError(n_bins=CE_BINS, norm="max", **kw),
        "hinge_cs": tc.MulticlassHingeLoss(multiclass_mode="crammer-singer", **kw),
        "hinge_ova": tc.MulticlassHingeLoss(multiclass_mode="one-vs-all", **kw),
        "exact": tc.MulticlassExactMatch(**kw),
        "dice": tc.Dice(**kw),
        "recall_at_p50": tc.MulticlassRecallAtFixedPrecision(min_value=0.5, thresholds=20, **kw),
    }, compute_groups=compute_groups)


def _rest_coco(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    kw = {"num_labels": COCO_ML_LABELS, "device": device}
    return MetricCollection({
        "coverage": tc.MultilabelCoverageError(**kw), "lrap": tc.MultilabelRankingAveragePrecision(**kw),
        "ranking_loss": tc.MultilabelRankingLoss(**kw), "exact": tc.MultilabelExactMatch(**kw),
        "recall_at_p50": tc.MultilabelRecallAtFixedPrecision(min_value=0.5, thresholds=ML_THRESHOLDS, **kw),
        "precision_at_r50": tc.MultilabelPrecisionAtFixedRecall(min_value=0.5, thresholds=ML_THRESHOLDS, **kw),
    }, compute_groups=compute_groups)


def _rest_binary(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "ece": tc.BinaryCalibrationError(n_bins=CE_BINS, device=device),
        "hinge": tc.BinaryHingeLoss(device=device), "hinge_sq": tc.BinaryHingeLoss(squared=True, device=device),
        "sens_at_spec90": tc.BinarySensitivityAtSpecificity(min_value=0.9, device=device),
        "spec_at_sens90": tc.BinarySpecificityAtSensitivity(min_value=0.9, thresholds=BIN_THRESHOLDS,
                                                            device=device),
    }, compute_groups=compute_groups)


def _rest_fairness(device, compute_groups):
    from torchmetrics_tpu_torch import classification as tc
    from torchmetrics_tpu_torch.collections import MetricCollection

    return MetricCollection({
        "fairness": tc.BinaryFairness(num_groups=2, task="all", device=device),
        "group_rates": tc.BinaryGroupStatRates(num_groups=2, device=device),
    }, compute_groups=compute_groups)


def _celeba_data(gen: torch.Generator):
    """The CelebA test split's shape: 19,962 rows of an attribute classifier's score, the
    binary attribute and a binary group (a second attribute, ~42 % of rows), with the
    score drawn a little higher in group 1, on the card."""
    dev = torch.device("cuda")
    groups = (torch.rand((CELEBA_ROWS,), generator=gen, device=dev) < 0.42).to(torch.int32)
    target = (torch.rand((CELEBA_ROWS,), generator=gen, device=dev) < 0.3 + 0.1 * groups).to(torch.int32)
    logits = 1.5 * torch.randn((CELEBA_ROWS,), generator=gen, device=dev) + 2.5 * target - 1.5 + 0.3 * groups
    return torch.sigmoid(logits), target, groups


def phase_rest() -> dict:
    """Phase 9 on one card, no sync: (i) the ImageNet-1k set, as probabilities and as their
    logits, through calibration, hinge, exact match, Dice and recall at fixed precision;
    (ii) the COCO-shaped multilabel set through the ranking metrics, exact match and two
    fixed operating points; (iii) the binary rows through calibration, hinge and two fixed
    operating points; (iv) group fairness over CelebA's test-split shape; (v) Dice's void
    error on a Cityscapes batch."""
    from torchmetrics_tpu_torch.kernels.binned_confmat import binned_confmat_multiclass, binned_confmat_multilabel
    from torchmetrics_tpu_torch.kernels.calibration import calibration_bins
    from torchmetrics_tpu_torch.kernels.ranking import ranking_pairs

    kernels = (calibration_bins, ranking_pairs, binned_confmat_multiclass, binned_confmat_multilabel)
    n_batches = -(-N_SAMPLES // BATCH)
    record = {}
    probs, target, _, _ = _main_path_data(torch.Generator(device="cuda").manual_seed(SEED))
    for form in ("probabilities", "logits"):
        scores = probs if form == "probabilities" else torch.log(probs)
        batches = lambda: (((scores[s:s + BATCH], target[s:s + BATCH]), {}) for s in range(0, N_SAMPLES, BATCH))  # noqa: E731
        rows = CPU_RERUN_BATCHES * BATCH
        slack = _ce_edge_slack(scores[:rows], target[:rows], N_CLASSES, CE_BINS)
        edge_rows = slack[0]
        ece_state = lambda tag, g, w: _ce_state_check(  # noqa: E731
            tag, [g[k] for k in ("conf_sum", "acc_sum", "count")], [w[k] for k in ("conf_sum", "acc_sum", "count")], slack)
        leg = _curve_leg(f"imagenet {form}", _rest_imagenet, batches, kernels, REST_RTOL, REST_ATOL,
                         {"ece_": ece_state} if edge_rows else None)
        ce_groups = sum(1 for g in leg["groups"] if any(m.startswith("ece_") for m in g))
        want = {"calibration_bins": n_batches * ce_groups, "ranking_pairs": 0,
                "binned_confmat_multiclass": n_batches, "binned_confmat_multilabel": 0}
        check(leg["launches"] == want, f"[rest imagenet {form}] launches {leg['launches']}, expected {want} "
                                       f"({ce_groups} calibration compute group(s))")
        t = leg["tensors"]
        for k in ("ece_l1", "ece_l2", "ece_max", "hinge_cs", "exact", "dice"):
            check(t[k].shape == () and bool(torch.isfinite(t[k])) and 0.0 <= float(t[k]) <= 1.5, f"[rest imagenet] {k} = {t[k]}")
        check(t["hinge_ova"].shape == (N_CLASSES,), "[rest imagenet] one-vs-all hinge a class")
        check(float(t["ece_l1"]) <= float(t["ece_l2"]) <= float(t["ece_max"]) + 1e-6, "[rest imagenet] l1 <= l2 <= max")
        leg["calibration_groups"], leg["edge_rows"] = ce_groups, edge_rows
        record[f"imagenet {form}"] = leg
        del scores, batches
    check(torch.allclose(record["imagenet probabilities"]["tensors"]["ece_l1"],
                         record["imagenet logits"]["tensors"]["ece_l1"], rtol=1e-3),
          "[rest imagenet] ECE of the probabilities and of their logits differ")

    scores, labels = _coco_multilabel_data(torch.Generator(device="cuda").manual_seed(SEED + 6))
    coco = lambda: (((scores[s:s + COCO_ML_BATCH], labels[s:s + COCO_ML_BATCH]), {})  # noqa: E731
                    for s in range(0, COCO_ML_IMAGES, COCO_ML_BATCH))
    coco_batches = -(-COCO_ML_IMAGES // COCO_ML_BATCH)
    leg = _curve_leg("coco", _rest_coco, coco, kernels, REST_RTOL, REST_ATOL)
    want = {"calibration_bins": 0, "ranking_pairs": 3 * coco_batches, "binned_confmat_multiclass": 0,
            "binned_confmat_multilabel": coco_batches}
    check(leg["launches"] == want, f"[rest coco] launches {leg['launches']}, expected {want}")
    check(sorted(sorted(g) for g in leg["groups"] if "recall_at_p50" in g) == [["precision_at_r50", "recall_at_p50"]],
          f"[rest coco] the two fixed operating points did not share a group: {leg['groups']}")
    t = leg["tensors"]
    check(0.5 < float(t["lrap"]) <= 1.0 and 0.0 <= float(t["ranking_loss"]) < 0.5 and float(t["coverage"]) >= 1.0,
          f"[rest coco] LRAP {t['lrap']}, loss {t['ranking_loss']}, coverage {t['coverage']}")
    record["coco"] = leg
    del scores, labels, coco

    conf, pred = probs.max(1)
    correct = (pred == target).to(torch.int32)
    del probs, target
    binary = lambda: (((conf[s:s + BATCH], correct[s:s + BATCH]), {}) for s in range(0, N_SAMPLES, BATCH))  # noqa: E731
    leg = _curve_leg("binary", _rest_binary, binary, kernels, REST_RTOL, REST_ATOL)
    want = {"calibration_bins": n_batches, "ranking_pairs": 0, "binned_confmat_multiclass": 0,
            "binned_confmat_multilabel": n_batches}
    check(leg["launches"] == want, f"[rest binary] launches {leg['launches']}, expected {want}")
    t = leg["tensors"]
    check(0.0 <= float(t["ece"]) < 1.0 and 0.0 < float(t["hinge"]) < 2.0, f"[rest binary] ECE {t['ece']}, hinge {t['hinge']}")
    record["binary"] = leg
    del conf, correct, binary

    preds, attr, groups = _celeba_data(torch.Generator(device="cuda").manual_seed(SEED + 12))
    celeba = lambda: (((preds[s:s + BATCH], attr[s:s + BATCH], groups[s:s + BATCH]), {})  # noqa: E731
                      for s in range(0, CELEBA_ROWS, BATCH))
    leg = _curve_leg("celeba", _rest_fairness, celeba, kernels, REST_RTOL, REST_ATOL)
    check(all(v == 0 for v in leg["launches"].values()), f"[rest celeba] launches {leg['launches']}")
    # the collection flattens the members' dicts: group_0, group_1, DP_i_j, EO_i_j
    rates = {k: v for k, v in leg["tensors"].items() if k.startswith("group_")}
    total = float(torch.stack(list(rates.values())).sum())
    check(len(rates) == 2 and abs(total - 2.0) < 1e-5, f"[rest celeba] each group's rates sum to 1: {rates}")
    fair = {k: v for k, v in leg["tensors"].items() if k.startswith(("DP_", "EO_"))}
    check(len(fair) == 2 and all(0.0 < float(v) <= 1.0 for v in fair.values()), f"[rest celeba] fairness {fair}")
    record["celeba"] = leg
    del preds, attr, groups, celeba

    # (v) Dice on Cityscapes targets with void 255 raises the JAX package's error
    from torchmetrics_tpu_torch.classification import Dice

    logits, seg_target = _seg_batch(torch.Generator(device="cuda").manual_seed(SEED + 5))
    errors = {}
    for ignore_index in (None, SEG_IGNORE):
        try:
            Dice(num_classes=SEG_SHAPE[1], ignore_index=ignore_index, device="cuda").update(logits, seg_target)
            errors[str(ignore_index)] = None
        except ValueError as err:
            errors[str(ignore_index)] = str(err)
    expected = "The highest `target` label must be below the C dimension of `preds`."
    check(all(e == expected for e in errors.values()), f"[rest dice] Cityscapes void: {errors}")
    record["cityscapes_dice"] = {"errors": errors}
    del logits, seg_target

    for name, leg in record.items():
        if name == "cityscapes_dice":
            continue
        extra = "" if "calibration_groups" not in leg else \
            f" ({leg['calibration_groups']} calibration compute group: {leg['launches']['calibration_bins']} " \
            f"calibration_bins launches for {leg['batches']} batches; {leg['edge_rows']} rows of the first " \
            f"{CPU_RERUN_BATCHES} batches within {EDGE_TOL} of a bin edge)"
        print(f"[rest] {name}: {leg['batches']} batches in {leg['leg_s']:.3f} s; compute groups {leg['groups']}; "
              f"collection update median {leg['update_ms_median']:.4f} ms (host clock, a synchronize after each), "
              f"compute {leg['compute_ms']:.4f} ms; launches {leg['launches']}{extra}; first {CPU_RERUN_BATCHES} "
              f"batches match the CPU path ({leg['cpu_compared']} tensors: integers equal, floats within rtol "
              f"{REST_RTOL}, atol {REST_ATOL}); values {leg['values']}")
        del leg["tensors"]
    print(f"[rest] cityscapes: Dice(num_classes=19) on a batch with void 255 raises ValueError({expected!r}) "
          f"with ignore_index None and 255")
    return record


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--json", help="also write the full record to this file")
    for flag in ("--worker", "--backend", "--init", "--out"):  # one rank of a phase-5/6 world
        parser.add_argument(flag, help=argparse.SUPPRESS)
    for flag in ("--rank", "--world"):
        parser.add_argument(flag, type=int, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU", file=sys.stderr)
        return 1
    if args.worker:
        return worker_main(args)
    sys.path.insert(0, REPO)
    from torchmetrics_tpu_torch.kernels.binned_confmat import binned_confmat_multiclass

    kernels = [binned_confmat_multiclass]
    sources = {
        "binned_confmat_multiclass": "torchmetrics_tpu_torch/csrc/binned_confmat.cu",
        "coco_match": "torchmetrics_tpu_torch/csrc/coco_match.cu",
        "confmat_multiclass": "torchmetrics_tpu_torch/csrc/confmat.cu",
        "binned_confmat_multilabel": "torchmetrics_tpu_torch/csrc/binned_confmat.cu",
        "calibration_bins": "torchmetrics_tpu_torch/csrc/calibration.cu",
        "ranking_pairs": "torchmetrics_tpu_torch/csrc/ranking.cu",
    }
    replaces = {
        "binned_confmat_multiclass": "torchmetrics_tpu/functional/classification/precision_recall_curve.py:128",
        "coco_match": "torchmetrics_tpu/functional/detection/matcher.py:29",
        "confmat_multiclass": "torchmetrics_tpu/functional/classification/confusion_matrix.py:65",
        "binned_confmat_multilabel": "torchmetrics_tpu/functional/classification/precision_recall_curve.py:152",
        "calibration_bins": "torchmetrics_tpu/functional/classification/calibration_error.py:96",
        "ranking_pairs": "torchmetrics_tpu/functional/classification/ranking.py:44",
    }

    device = phase_device()
    build_s = phase_build()
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB, past the 50 MB L2
    kernel_rows = phase_kernels(flush)
    kernel_rows["coco_match"], chunk_shapes = phase_matcher(flush)
    kernel_rows["confmat_multiclass"] = phase_confmat(flush)
    kernel_rows["binned_confmat_multilabel"] = phase_multilabel_kernel(flush)
    kernel_rows["calibration_bins"] = phase_calibration_kernel(flush)
    kernel_rows["ranking_pairs"] = phase_ranking_kernel(flush)
    del flush
    main = phase_main_path(kernels)
    sync = phase_sync()
    ragged = phase_ragged(chunk_shapes)
    tower = phase_tower()
    curves = phase_curves()
    rest = phase_rest()

    # launches of each kernel on the paths that run it: the eval step (phase 4),
    # every rank of the sync worlds (phase 5) and of the ragged worlds (phase 6)
    by_path = {
        "binned_confmat_multiclass": {"eval": main["launches"]["binned_confmat_multiclass"]},
        "coco_match": {},
        "confmat_multiclass": {f"tower {leg}": tower[leg]["launches"] for leg in ("imagenet", "cityscapes")},
        "binned_confmat_multilabel": {f"curves {leg}": curves[leg]["launches"]["binned_confmat_multilabel"]
                                      for leg in ("coco", "binary")},
        "calibration_bins": {f"rest {leg}": rest[leg]["launches"]["calibration_bins"]
                             for leg in ("imagenet probabilities", "imagenet logits", "binary")},
        "ranking_pairs": {"rest coco": rest["coco"]["launches"]["ranking_pairs"]},
    }
    for leg in ("imagenet probabilities", "imagenet logits"):
        by_path["binned_confmat_multiclass"][f"rest {leg}"] = rest[leg]["launches"]["binned_confmat_multiclass"]
    for leg in ("coco", "binary"):
        by_path["binned_confmat_multilabel"][f"rest {leg}"] = rest[leg]["launches"]["binned_confmat_multilabel"]
    for name, record in (("sync", sync), ("ragged", ragged)):
        for label, results in record.items():
            for kernel, count in ((k, sum(r["launches"][k] for r in results)) for k in results[0]["launches"]):
                by_path[kernel][f"{name} {label}"] = count
    line = {"kernels": []}
    for name in sources:
        first_row = kernel_rows[name][0]  # the main path's shape
        check(all(n > 0 for n in by_path[name].values()) and by_path[name], f"{name} did not launch: {by_path[name]}")
        line["kernels"].append({
            "name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
            "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
            "max_abs_err": max(r["max_abs_err"] for r in kernel_rows[name]),
            "ms": first_row["ms"], "stream_ms": first_row["stream_ms"], "plain_ms": first_row["plain_ms"],
            "bound_ms": first_row["bound_ms"], "bound_by": first_row["bound_by"], "library_ms": None,
            **{k: first_row[k] for k in ("two_call_ms", "bucketize_bincount_ms", "softmax_bucketize_bincount_ms")
               if k in first_row},
        })
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": device, "build_s": build_s, "kernels": kernel_rows, "main_path": main,
                       "sync": sync, "ragged": ragged, "tower": tower, "curves": curves, "rest": rest}, f, indent=1)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["name"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
