#!/usr/bin/env python3
"""Where the port's redesigned kernels spend their time, on one GPU: ``ranking_pairs``' sort,
``binned_confmat_multilabel``'s label-group width, ``calibration_bins``' design choices,
``retrieval_groups``' counting threshold, ``ssim_window``'s tile and blocking, ``pairwise_lp``'s
tiles, staging and float form, ``sdr_toeplitz``'s step and block, ``snr_moments``' loads and merge,
``bert_greedy_match``'s, ``confmat_multiclass``' and ``poly_mmd``'s redesigns against the kernels before them,
and the loads ``quantile_hist`` keeps in flight.

    python3 tools/kernel_ablation.py [--sections ranking,multilabel,calibration,calibration-widths,retrieval,
                                                  retrieval-occupancy,retrieval-builds,retrieval-fault,ssim,
                                                  pairwise,sdr,snr,bert,confmat,poly_mmd,quantile_hist]
                                     [--parent CHECKOUT] [--fault-builds NAMES] [--fault-trials N]
                                     [--sass PATH] [--json PATH]

Ranking: ``csrc/ranking.cu`` is copied, ``#if`` switches are put around the
sort and around each kind of its stages (in registers, by warp shuffles,
through shared memory), and the variants are built with the port's ``nvcc``
flags, all at once. Each variant is timed by its C entry, LRAP, at (64, 4096),
(32, 1000) and the COCO batch (256, 80), with 4, 8 and 16 words a thread
where the width allows; a variant without some stages sorts wrongly and is
timed only. Multilabel: the launcher's plan is given 8, 4, 2 and 1 labels a
block at the COCO batch and its last batch (56, 80), in two turns, forward
then backward.

Calibration: ``csrc/calibration.cu`` is copied and built with ``-D``
switches into variants: an empty launch, the row pass alone (no merge), the
merge tail alone (each block adds one row to each histogram), the ticket
alone, two fences about a relaxed ticket atomic (by every thread, or by
thread 0 alone after the barrier, as a cooperative-groups grid sync does) in
place of the shipped acq_rel ticket atomic, 4 and 16 copies of the accumulator (block b into copy b % N), blocks of
1,024 threads, a merge through thread-block clusters of 8 (the leader sums
its cluster's shared histograms through distributed shared memory; only
leaders reach the accumulator), merged-lane adds (``__match_any_sync`` on
the bin, the peers' words summed by ``__reduce_add_sync``) in place of one
atomic a lane on the binary path, 64-bit shared atomics in place of the two
32-bit halves, and in the argmax of the probabilities a divide a score, or
the shipped filter (only the exponentials at or above 1 - 2^-22 divided) put
in a helper function. The shipped build is timed at 1, 2 and 4 warps a row and with one
block against the launcher's grid at growing batches (the one-block
threshold). Calibration widths: the shipped source with every width
instantiated, timed at 1, 2 and 4 warps a row from 848 to 65,536 rows of
1,000 logits (each under phase 3's state check against the plain version),
which sets the plan's width thresholds. ``--parent`` names a checkout of the commit before the
redesign, whose kernel (one partial histogram a block, merged by the last
block) is built and timed beside it at the main path's three shapes.

The retrieval and SSIM sections build variants of ``csrc/retrieval.cu`` and
``csrc/ssim.cu`` by replacing source text (a constant's value, a line), all at
once. Retrieval: the source with its counting thresholds (``kCountShort``,
``kCountLong``) set so that every query counts, or every query sorts, over
batches of about 4 M rows of queries of 256 to 16,384 documents (and one query
of 100,000, the long path), each query with exactly ``n_pos`` relevant
documents from 0 to 256: AP and AUROC@10 (held equal between the two paths
within the phase 3 tolerance), which sets the thresholds. Retrieval
occupancy: the source built with its registers sized for 1,024 and 2,048
threads an SM (``kThreadsAnSm``), at 4 and 8 documents a thread, at MS
MARCO's shape. Retrieval builds: the source without its 16-word short path,
its long path or both, and with eight ballots in place of the digit match,
each build's ptxas report printed, timed at MS MARCO's shape. Retrieval
fault: phase 3's small queries with non-finite scores (1 to 64 documents)
over 20 seeds, every measure, through the shipped build and builds with the
counting path's warp sums by ``__reduce_add_sync`` (an earlier form, whose
AUROC was wrong at 33 to 64 documents while one kernel also wrote the ranked
layout), alone and with one change each: ptxas at ``-O1`` or ``-O2``, the
dynamic shared memory filled with a NaN pattern at entry (a read of a word
the kernel did not write then shows), registers for blocks of 256 (no
spills), ``count_against`` kept out of line: the queries of each measure
that differ from the plain version. SSIM: the source built with its column-pass rows a
thread (``kColRows``: 8 or 4, tiles of 32 x 64 or 32 x 32), row-pass outputs
a thread (``kRowOuts``: 4 or 8) and blocks an SM in its launch bounds
(``kMinBlocks``), with the tile loaded by plain loads and stores in place of
asynchronous copies, and with a pass left out (the column pass, or the row
pass: a variant that computes wrong values, timed only), at DIV2K's batch and
its four smaller MS-SSIM scales, each held against the shipped build.

Pairwise: ``csrc/pairwise.cu`` built with its tile forced to 8 x 8 or 4 x 4
sums a thread, one staged chunk, chunks of 16 columns, the integer kinds'
register caps moved, y read one column at a time, and ``powf`` for every pair
of a float p, beside the shipped build and, with ``--parent`` (a checkout of
``e060d72``), the kernel before the redesign, at Market-1501's shape and 1,024 x 1,024 x 512
for p = 1, int 2, int 3 and 1.5, each under phase 3's check against the plain
version, in two turns; each kernel's innermost sum loop from ``cuobjdump
-sass`` by instruction (``--sass PATH`` keeps the whole listing).

SDR: ``csrc/sdr_toeplitz.cu`` built with at least 1, 2, 8 or 16 slots a thread
(the shipped build: 4), with blocks of up to 1,024 threads at up to 4 or 8
slots a thread (shipped: up to 2), with beta's reciprocal by ``rcp.approx`` and
two Newton steps (alone and at 1 or 2 slots a thread) in place of the IEEE
division, and with mu and gamma divided in the chain, beside the shipped build
and, with ``--parent`` (a checkout of ``26973ba``), the Levinson kernel before the redesign, at
the Libri2Mix batch's 32 rows and PIT(SDR)'s 64 of L = 512, 32 rows of L = 64
and 2 of L = 8,192, each held against a float64 LU as phase 3 holds it, in two
turns. Four timing-only builds (their values are wrong) record the SM cycles
of a step in ``x[0, 0]``: the shipped step, and the step without the slot
updates, the shift exchange or the reciprocal. Micro chains time, by
``clock64`` in one block, dependent fp64 fused multiply-adds, IEEE
reciprocals, ``rcp.approx`` with two Newton steps, block barriers of 32 to
1,024 threads and the least step (a barrier, a shared read, a fused
multiply-add, a write): the latencies of ``chip_smoke``'s least-chain bound.

SNR: ``csrc/snr_moments.cu`` built with 2, 4 or 16 loads a row a thread
(shipped: 8), clusters of 4 or 16 blocks (shipped: 8), the register batch
replaced by a ring of 4 TMA bulk copies into shared memory (rows mode), the
cluster merge replaced by partials, fences and a ticket for every chunk or by
the first block's reads of its peers' shared memory between two cluster
barriers (shipped: each block writes into the first block's shared memory,
one barrier), and the plan at 4 or 8 blocks an SM, beside the shipped build
and, with ``--parent``, the kernel before the redesign with its plan, at the Libri2Mix batch's
SI-SNR rows, PIT(SI-SNR) pairs and SA-SDR groups and one 10-minute 16 kHz
clip, each held against a float64 evaluation as phase 3 holds it and
launched twice for determinism, in two turns.

BERT: ``csrc/bert_match.cu`` built as shipped and with one change each: the
split by ``cvt.rna.tf32.f32`` in place of the integer add and mask (its bits
must equal the shipped build's), the prediction rows always wgmma's rows (no choice of
roles), copies without the 256-byte L2 fetch, three stages; and, timed only,
one TF32 pass (hi.hi alone), the copies alone (no split, no products) and
no copies (the split and the products of stale stages): the last two
bracket the memory's and the arithmetic's share. With ``--parent`` (a
checkout of ``46523d4``) the kernel before the redesign (64 x 64 tiles of
float32 FMA sums) is built from that checkout's source. Each build's
registers, shared memory and spills from ``-Xptxas -v`` are printed; each is
held against the plain version within phase 3's 1e-5 and launched twice for
determinism at WMT16 newstest2016's 2,999 pairs (128 x 128 x 1,024, lengths
10-128, phase 3's case (a)) and at the same pairs cut to H = 16 (the fixed
cost of a pair), and timed after a flush in two turns (parent, new, new,
parent) and back to back.

Confmat: ``csrc/confmat.cu`` built as shipped and with one change each: in the rows kernel the target
read early (every lane, before the scores), timing-only builds that store the cell or the argmax in place
of the atomic, or load nothing, the state row (a bulk prefetch) or each lane's candidate cell prefetched
to L2, the row by one TMA bulk copy into shared memory, 16-byte loads with a 256-byte L2 fetch; on the
labels path ``__match_any_sync`` on every path, the state prefetched to L2 at launch, no atomics (timing
only); the shipped build called with the rows in blocks of 64 threads, the labels in blocks of 64 or
128, and at case (c) on the shared histogram; with ``--parent`` (a checkout of ``7e0446e``) that
commit's kernel with its own plan. Each checked build is held equal to the plain version at its cases of phase
3's (a) ImageNet-1k batch, (b) Cityscapes batch, (c) nominal's 1,024 labels at C = 42 and (d)
clustering's 50,000 at C = 1,000, timed after a flush in two turns and back to back, and each rows
build's order of loads, shuffles and atomics is printed from ``cuobjdump -sass``.

QUANTILE_HIST: ``csrc/quantile_hist.cu`` built with 1, 2, 4, 8 (shipped) and 16
entries a thread loaded before it counts any (``kUnroll``), each timed by its C
entry after a flush at phase 3's three timed cases and the MS-COCO set in one
launch, under phase 3's check (the state equal to the plain version's).

POLY_MMD: ``csrc/poly_mmd.cu`` built as shipped and with one change each: the
accumulators promoted every chunk or never (the tensor cores' float32 sums,
unpromoted, lose 1e-6 of the terms' scale at case (f)), three slots, the rows'
A fragments by 4-byte loads in the features' own order, one producer
warpgroup, other register splits, the split by ``cvt.rna.tf32.f32``; and,
timed only, one TF32 pass, no split, no loads (of the rows, of the columns, of
both) and the products alone (with and without the promotion). With
``--parent`` (a checkout of ``4c65b25``) the kernel before the redesign (8 x 8
float32 FMA sums a thread) is built from that checkout's source. Each build's
registers, spills and ptxas performance warnings from ``-Xptxas -v`` are
printed; each is held against the plain version within phase 3's ``KID_TOL``
and against a float64 evaluation at phase 3's cases (a), KID's defaults (100
subsets of 1,000 of 10,000 x 2,048), and (f), the same with 8 outlier
dimensions, and timed at (a) after a flush in two turns (parent, new, new,
parent). The shipped build is also timed at (a) with a +inf feature in 1 % of
the real rows and in every one of them, where the products that come out inf
or NaN are taken again one thread an entry, its NaN held to the plain
version's.

Times are ``chip_smoke.time_ms``'s: CUDA events around one call after an L2
flush that leaves no dirty line, a spin kernel holding the card while the host
enqueues the call; medians of 30 unless a section says otherwise. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from torchmetrics_tpu_torch.kernels import _build  # noqa: E402
from torchmetrics_tpu_torch.kernels import binned_multilabel as kbm  # noqa: E402
from torchmetrics_tpu_torch.kernels import calibration as kce  # noqa: E402
from torchmetrics_tpu_torch.kernels import pairwise as kpw  # noqa: E402
from torchmetrics_tpu_torch.kernels import ranking as krk  # noqa: E402
from torchmetrics_tpu_torch.kernels import retrieval as krt  # noqa: E402
from torchmetrics_tpu_torch.kernels import sdr_toeplitz as ksdr  # noqa: E402
from torchmetrics_tpu_torch.kernels import ssim as kss  # noqa: E402

SWITCHES = {  # a stage kind's switch: the source text it guards, and the guarded text
    "SORT": ("  bitonic_sort<E>(v, s_sort, a.width, group, t, lane);",
             "  if (SORT) bitonic_sort<E>(v, s_sort, a.width, group, t, lane);"),
    "SHARED": ("    if (j >= 32 * E) {  // the partner is in another warp",
               "    if (!SHARED && j >= 32 * E) j = 16 * E;\n    if (SHARED && j >= 32 * E) {  // the partner is in another warp"),
    "SHUFFLE": ("    for (; j >= E; j >>= 1) {\n      const int m = j / E;",
                "    for (; SHUFFLE && j >= E; j >>= 1) {\n      const int m = j / E;"),
    "REGISTER": ("      if (jj < k) {", "      if (REGISTER && jj < k) {"),
}
VARIANTS = {"whole": None, "no sort": "SORT", "no shared-memory stages": "SHARED", "no shuffle stages": "SHUFFLE",
            "no register stages": "REGISTER"}
RANKING_SHAPES = ((64, 4096), (32, 1000), (cs.COCO_ML_BATCH, cs.COCO_RANK_LABELS))


def _ranking_variants(workdir: str) -> dict:
    src = open(os.path.join(_build.CSRC_DIR, "ranking.cu")).read()
    for old, new in SWITCHES.values():
        if src.count(old) != 1:
            raise RuntimeError(f"kernel_ablation: the ranking source changed, cannot place a switch at {old!r}")
        src = src.replace(old, new)
    path = os.path.join(workdir, "ranking_ablation.cu")
    with open(path, "w") as f:
        f.write(src)
    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    running = {}
    for name, off in VARIANTS.items():
        lib = os.path.join(workdir, f"lib{len(running)}.so")
        defines = [f"-D{s}={int(s != off)}" for s in SWITCHES]
        cmd = [_build._nvcc(), *flags, *defines, "-o", lib, path]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    entries = {}
    for name, (proc, lib) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"kernel_ablation: nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(lib).ranking_pairs_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, ctypes.c_longlong, i, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def _ranking(flush: torch.Tensor, gen: torch.Generator) -> dict:
    rows = {}
    with tempfile.TemporaryDirectory() as workdir:
        entries = _ranking_variants(workdir)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for n, labels in RANKING_SHAPES:
            preds, target = cs._ranking_case(n, labels, gen)
            out = torch.empty(n, device="cuda")
            want = krk.ranking_pairs(preds, target, "lrap")
            width = max(32, 1 << (labels - 1).bit_length())
            for items in (4, 8, 16):
                if width <= krk.WARP_WIDTH:
                    g = krk.plan(n, labels, "lrap", sms)
                    if items != g.items:
                        continue
                elif not 64 <= width // items <= krk.MAX_THREADS:
                    continue
                else:
                    g = krk.Plan(width, items, width // items, width // items, n, (width + width // 16) * 8)
                for name, fn in entries.items():
                    args = (preds.data_ptr(), target.data_ptr(), 0, n, labels, 0, 0, krk.MEASURES["lrap"],
                            out.data_ptr(), g.width, g.items, g.group, g.threads, g.blocks, g.shared_bytes)

                    def call(fn=fn, args=args):
                        err = fn(*args, torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"kernel_ablation: launch failed with CUDA error {err}")

                    call()
                    torch.cuda.synchronize()
                    if name == "whole":
                        cs.check(torch.allclose(out, want, rtol=1e-6, atol=1e-7), f"the whole sort differs ({n}, {labels})")
                    key = f"({n}, {labels}), {items} words a thread, {name}"
                    rows[key] = cs.time_ms(call, flush)
                    print(f"[ranking] {key}: {rows[key]:.4f} ms after an L2 flush", flush=True)
    return rows


def _multilabel(flush: torch.Tensor, gen: torch.Generator) -> dict:
    prc = importlib.import_module("torchmetrics_tpu_torch.functional.classification.precision_recall_curve")
    rows = {}
    default = kbm.GROUP_LABELS
    try:
        for n in (cs.COCO_ML_BATCH, 40_504 % cs.COCO_ML_BATCH):
            p, t, w, thr, state = cs._multilabel_inputs(n, cs.ML_LABELS, cs.ML_THRESHOLDS, 0.0, (), gen)
            sorted_thr, order = prc._sort_thresholds(thr)
            want = prc._binned_confmat_multilabel_accumulate_plain(state, p, t, w, thr)
            widths = (8, 4, 2, 1)
            for group in widths + widths[::-1]:  # forward, then backward
                kbm.GROUP_LABELS = group
                kbm.plan.cache_clear()
                # the plan takes one label a block at this size unless there are more labels than SMs:
                # force the group width by planning as if the card had one SM
                real = kbm.sm_count
                kbm.sm_count = lambda device: 1
                try:
                    fused = lambda: kbm.binned_confmat_multilabel(state, p, t, w, sorted_thr, order)  # noqa: E731
                    cs.check(torch.equal(fused(), want), f"multilabel update differs at {group} labels a block")
                    ms = cs.time_ms(fused, flush)
                finally:
                    kbm.sm_count = real
                rows.setdefault(f"({n}, {cs.ML_LABELS}), T={cs.ML_THRESHOLDS}, {group} labels a block", []).append(ms)
            for key, times in rows.items():
                if key.startswith(f"({n},"):
                    print(f"[multilabel] {key}: {' / '.join(f'{x:.4f}' for x in times)} ms after an L2 flush "
                          f"(forward / backward)", flush=True)
    finally:
        kbm.GROUP_LABELS = default
        kbm.plan.cache_clear()
    return rows


# ---------------------------------------------------------------- calibration_bins
# The merged-lane adds, measured against one atomic a lane and left out: the lanes of one bin sum their words over
# the peers (__match_any_sync, __reduce_add_sync) and their first lane adds them.
MERGED_ADDS = """__device__ __forceinline__ void add_rows_merged(const Hist& h, int variant, int nb, int n_bins, bool live,
                                                float conf, int acc, bool w) {
  const bool is_nan = conf != conf, counted = live && w;
  const int bin = live ? bin_of(conf, n_bins) : -1;
  const unsigned peers = __match_any_sync(kFull, bin);
  const unsigned long long fixed = counted && !is_nan ? fixed_of(conf) : 0ull;
  const unsigned lo = __reduce_add_sync(peers, static_cast<unsigned>(fixed & 0xffffull));
  const unsigned hi = __reduce_add_sync(peers, static_cast<unsigned>(fixed >> 16));
  const unsigned count = __reduce_add_sync(peers, counted ? 1u : 0u);
  const unsigned accs = __reduce_add_sync(peers, counted ? static_cast<unsigned>(acc) : 0u);
  const unsigned nans = __reduce_add_sync(peers, live && is_nan ? 1u : 0u);
  if (bin < 0 || static_cast<int>(threadIdx.x & 31) != __ffs(peers) - 1) return;
  const unsigned long long sum = (static_cast<unsigned long long>(hi) << 16) + lo;
  if (sum) add_fixed(h.conf + variant * nb + bin, sum);
  if (count) atomicAdd(h.count + variant * nb + bin, static_cast<int>(count));
  if (accs) atomicAdd(h.acc + variant * nb + bin, static_cast<int>(accs));
  if (nans) atomicAdd(h.nan + variant, static_cast<int>(nans));
}

"""
CE_SWITCHES = {  # the source text each switch is placed at, and what replaces it
    "include": ("#include <cuda_runtime.h>\n",
                "#include <cuda_runtime.h>\n#include <cooperative_groups.h>\n"
                "#if CLUSTER\n#define CLUSTER_DIMS __cluster_dims__(8, 1, 1)\n#else\n#define CLUSTER_DIMS\n#endif\n"),
    "threads": ("constexpr int kThreads = 256;", "constexpr int kThreads = THREADS;"),
    "empty rows": ("__global__ void __launch_bounds__(kThreads) calib_rows_kernel(Args a) {\n",
                   "__global__ void CLUSTER_DIMS __launch_bounds__(kThreads) calib_rows_kernel(Args a) {\n"
                   "  if (EMPTY) return;\n"),
    "empty binary": ("calib_binary_kernel(Args a) {\n", "calib_binary_kernel(Args a) {\n  if (EMPTY) return;\n"),
    "row pass": ("r0 < a.n_rows;", "ROWS && r0 < a.n_rows;"),
    "tail": ("  finish(a, h, outside);\n}\n\n// A warp a row of more than",
             "  if (!ROWS && FAKE_ROWS && threadIdx.x == 0) {\n"
             "    add_row(h, 0, a.nb, a.n_bins, 0.5f, 1, true);\n"
             "    add_row(h, 1, a.nb, a.n_bins, 0.5f, 1, true);\n"
             "  }\n"
             "  if (TAIL) finish(a, h, outside);\n}\n\n// A warp a row of more than"),
    "copies": ("  const Hist g = hist_at(a.sum_conf, a.sum_int, nb);\n",
               "  const int copy = blockIdx.x % COPIES;  // block b adds into copy b % COPIES; the flag and ticket in copy 0\n"
               "  const Hist g = hist_at(a.sum_conf + copy * 2 * nb, a.sum_int + copy * int_words(nb), nb);\n"
               "  const Hist g0 = hist_at(a.sum_conf, a.sum_int, nb);\n"),
    "cluster merge": ("  for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x) {\n    if (h.conf[i]) atomicAdd(g.conf + i",
                      "#if CLUSTER\n"
                      "  namespace cg = cooperative_groups;\n"
                      "  cg::cluster_group cluster = cg::this_cluster();\n"
                      "  if (threadIdx.x == 0) *h.outside = any_out;\n"
                      "  cluster.sync();\n"
                      "  if (cluster.block_rank() == 0) {\n"
                      "    for (unsigned r = 1; r < cluster.num_blocks(); ++r) {\n"
                      "      const unsigned long long* rc = cluster.map_shared_rank(h.conf, r);\n"
                      "      const int* ri = cluster.map_shared_rank(h.acc, r);\n"
                      "      for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x) h.conf[i] += rc[i];\n"
                      "      for (int i = threadIdx.x; i < 4 * nb + 3; i += blockDim.x) h.acc[i] += ri[i];\n"
                      "    }\n"
                      "  }\n"
                      "  cluster.sync();  // no block leaves while its leader reads its shared memory\n"
                      "  if (cluster.block_rank() != 0) return;\n"
                      "#endif\n"
                      "  for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x) {\n    if (h.conf[i]) atomicAdd(g.conf + i"),
    "flag": ("if (threadIdx.x == 0 && any_out) atomicAdd(g.outside, 1);",
             "if (threadIdx.x == 0 && (CLUSTER ? *h.outside : any_out)) atomicAdd(g0.outside, 1);"),
    "ticket": ("last = ticket_acq_rel(g.ticket) == static_cast<int>(gridDim.x) - 1;",
               "{\n    if (FENCE == 1) __threadfence();  // the block's adds, ordered before by the barrier\n"
               "    last = (FENCE == 2 ? ticket_acq_rel(g0.ticket) : atomicAdd(g0.ticket, 1)) ==\n"
               "           static_cast<int>(gridDim.x) / (CLUSTER ? 8 : 1) - 1;\n"
               "    if (FENCE == 1) __threadfence();\n  }"),
    "release fence": ("  __syncthreads();\n  int last = 0;\n", "  if (FENCE == 0) __threadfence();\n  __syncthreads();\n  int last = 0;\n"),
    "acquire fence": ("  if (!__syncthreads_or(last)) return;\n",
                      "  if (!__syncthreads_or(last)) return;\n  if (FENCE == 0) __threadfence();\n"),
    "read copies": (
        "  const int v = __ldcg(g.outside) > 0 ? 1 : 0;\n"
        "  for (int bin = threadIdx.x; bin < nb; bin += blockDim.x) {\n"
        "    write_bin(a, bin, __ldcg(g.conf + v * nb + bin), __ldcg(g.acc + v * nb + bin), __ldcg(g.count + v * nb + bin),\n"
        "              bin == 0 ? __ldcg(g.nan + v) : 0);\n"
        "  }\n",
        "  const int v = __ldcg(g0.outside) > 0 ? 1 : 0;\n"
        "  for (int bin = threadIdx.x; bin < nb; bin += blockDim.x) {\n"
        "    unsigned long long conf = 0;\n"
        "    int acc = 0, count = 0, nan = 0;\n"
        "#pragma unroll\n"
        "    for (int c = 0; c < COPIES; ++c) {\n"
        "      const Hist gc = hist_at(a.sum_conf + c * 2 * nb, a.sum_int + c * int_words(nb), nb);\n"
        "      conf += __ldcg(gc.conf + v * nb + bin);\n"
        "      acc += __ldcg(gc.acc + v * nb + bin);\n"
        "      count += __ldcg(gc.count + v * nb + bin);\n"
        "      if (bin == 0) nan += __ldcg(gc.nan + v);\n"
        "    }\n"
        "    write_bin(a, bin, conf, acc, count, nan);\n"
        "  }\n"),
    "zero copies": ("  for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x) g.conf[i] = 0ull;\n"
                    "  for (int i = threadIdx.x; i < int_words(nb); i += blockDim.x) g.acc[i] = 0;\n",
                    "  for (int i = threadIdx.x; i < COPIES * 2 * nb; i += blockDim.x) a.sum_conf[i] = 0ull;\n"
                    "  for (int i = threadIdx.x; i < COPIES * int_words(nb); i += blockDim.x) a.sum_int[i] = 0;\n"),
    "divides": ("        if (k >= 0 && cand == INT_MAX && x[u] >= kTieFloor && (x[u] == 1.0f || x[u] / sum == pbest)) cand = k;\n",
                "#if DIVIDES == 1  // every probability divided\n"
                "        if (k >= 0) {\n          const float q = x[u] / sum;\n"
                "          if (q == pbest && cand == INT_MAX) cand = k;\n        }\n"
                "#elif DIVIDES == 2  // the shipped test in a helper\n"
                "        if (k >= 0 && cand == INT_MAX && ties_max_probability(x[u], sum, pbest)) cand = k;\n"
                "#else\n"
                "        if (k >= 0 && cand == INT_MAX && x[u] >= kTieFloor && (x[u] == 1.0f || x[u] / sum == pbest)) cand = k;\n"
                "#endif\n"),
    "filter helper": ("// JAX's clip(floor(conf * n_bins).astype(int32), 0, n_bins)",
                      "__device__ __forceinline__ bool ties_max_probability(float e, float sum, float pbest) {\n"
                      "  return e >= 1.0f - 1.0f / 4194304.0f && (e == 1.0f || e / sum == pbest);\n}\n\n"
                      "// JAX's clip(floor(conf * n_bins).astype(int32), 0, n_bins)"),
    "64-bit shared atomics": ("  unsigned* word = reinterpret_cast<unsigned*>(p);  // little-endian: the low word first\n",
                              "  if (ATOMIC64) {\n    atomicAdd(p, v);\n    return;\n  }\n"
                              "  unsigned* word = reinterpret_cast<unsigned*>(p);  // little-endian: the low word first\n"),
    "merged adds": ("template <typename U>\n__device__ __forceinline__ void target_of", MERGED_ADDS +
                    "template <typename U>\n__device__ __forceinline__ void target_of"),
    "merged binary": ("      if (live[j]) {\n        if (pick != 1) add_row(h, 0, a.nb, a.n_bins, x[j], t[j], w[j]);\n",
                      "      if (MERGED) {\n        add_rows_merged(h, 0, a.nb, a.n_bins, live[j], x[j], t[j], w[j]);\n"
                      "        add_rows_merged(h, 1, a.nb, a.n_bins, live[j], sigmoid(x[j]), t[j], w[j]);\n"
                      "      } else if (live[j]) {\n        if (pick != 1) add_row(h, 0, a.nb, a.n_bins, x[j], t[j], w[j]);\n"),
}
CE_DEFAULTS = {"THREADS": 256, "COPIES": 1, "FENCE": 2, "EMPTY": 0, "ROWS": 1, "FAKE_ROWS": 1, "TAIL": 1, "CLUSTER": 0,
               "MERGED": 0, "DIVIDES": 0, "ATOMIC64": 0}
CE_VARIANTS = {"shipped": {}, "empty launch": {"EMPTY": 1}, "row pass alone": {"TAIL": 0},
               "merge tail alone": {"ROWS": 0}, "ticket alone": {"ROWS": 0, "FAKE_ROWS": 0},
               "fences by every thread": {"FENCE": 0}, "thread 0 fences": {"FENCE": 1},
               "ticket alone, fences by every thread": {"ROWS": 0, "FAKE_ROWS": 0, "FENCE": 0},
               "ticket alone, thread 0 fences": {"ROWS": 0, "FAKE_ROWS": 0, "FENCE": 1},
               "1,024 threads a block": {"THREADS": 1024}, "4 accumulator copies": {"COPIES": 4},
               "16 accumulator copies": {"COPIES": 16}, "cluster merge": {"CLUSTER": 1},
               "merged-lane adds": {"MERGED": 1}, "every score divided": {"DIVIDES": 1},
               "the divide filter in a helper": {"DIVIDES": 2},
               "64-bit shared atomics": {"ATOMIC64": 1}}
CE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
               ctypes.c_int, ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 8
PARENT_COMMIT = "fd83d3f"  # the kernel before the redesign: a partial histogram pair a block, merged by the last


def _nvcc_all(jobs: dict) -> dict:
    """Build ``{name: (source, defines)}`` into libraries at once; ``{name: ctypes.CDLL}``."""
    flags = [f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"]
    running = {}
    for name, (path, defines) in jobs.items():
        lib = os.path.join(os.path.dirname(path), f"lib{len(running)}.so")
        cmd = [_build._nvcc(), *flags, *defines, "-o", lib, path]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"kernel_ablation: nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def _calibration_libraries(workdir: str, parent) -> dict:
    src = open(os.path.join(_build.CSRC_DIR, "calibration.cu")).read()
    for old, new in CE_SWITCHES.values():
        if src.count(old) != 1:
            raise RuntimeError(f"kernel_ablation: the calibration source changed, cannot place a switch at {old!r}")
        src = src.replace(old, new)
    path = os.path.join(workdir, "calibration_ablation.cu")
    with open(path, "w") as f:
        f.write(src)
    jobs = {name: (path, [f"-D{k}={v}" for k, v in {**CE_DEFAULTS, **over}.items()])
            for name, over in CE_VARIANTS.items()}
    if parent:
        old = os.path.join(workdir, "parent", "calibration.cu")
        os.makedirs(os.path.dirname(old))
        shutil.copy(os.path.join(parent, "torchmetrics_tpu_torch", "csrc", "calibration.cu"), old)
        jobs[f"parent ({PARENT_COMMIT})"] = (old, [])
    libs = _nvcc_all(jobs)
    entries = {}
    for name, lib in libs.items():
        fn = lib.calibration_bins_launch
        if name.startswith("parent"):  # ... conf_part, int_part, ticket, mode, blocks, stream
            fn.argtypes = CE_ARGTYPES + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        else:  # ... accumulator (conf, int words), mode, warps a row, blocks, stream
            fn.argtypes = CE_ARGTYPES + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def _ce_call(fn, parent: bool, state, preds, target, c, mode: str, warps: int, blocks: int, copies: int = 1):
    """One launch of a variant's C entry; returns a callable that launches again and the new state."""
    nb = state[0].shape[0]
    new = [torch.empty_like(x) for x in state]
    n = preds.numel() if c is None else preds.numel() // c
    head = (preds.data_ptr(), kce.PRED_KINDS[preds.dtype], target.data_ptr(), kce.TARGET_KINDS[target.dtype],
            n, c or 1, nb - 1, 0, 0, *(x.data_ptr() for x in state), *(x.data_ptr() for x in new))
    if parent:
        conf_part = torch.empty((blocks, 2, nb), dtype=torch.int64, device="cuda")
        int_part = torch.empty((blocks, 4 * nb + 3), dtype=torch.int32, device="cuda")
        ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
        tail = (conf_part.data_ptr(), int_part.data_ptr(), ticket.data_ptr(), kce.MODES[mode], blocks)
        keep = (conf_part, int_part, ticket)
    else:
        scratch = torch.zeros(copies * kce.SCRATCH_BYTES // 8 + 1, dtype=torch.int64, device="cuda")
        tail = (scratch.data_ptr(), scratch.data_ptr() + copies * 2 * nb * 8, kce.MODES[mode], warps, blocks)
        keep = (scratch,)

    def call(keep=keep):
        err = fn(*head, *tail, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kernel_ablation: calibration launch failed with CUDA error {err}")

    call()
    return call, new


def _calibration(flush: torch.Tensor, gen: torch.Generator, parent) -> dict:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}

    def shipped_plan(n, c, warps=None, blocks=None, threads=kce.THREADS):
        """The launcher's plan, or W warps a row, a given grid, or blocks of ``threads`` threads."""
        g = kce.plan(n, c, cs.CE_BINS, sms)
        if warps is not None or threads != kce.THREADS:
            w = g.warps_per_row if warps is None else warps
            g = g._replace(warps_per_row=w, threads=threads,
                           blocks=min(-(-n // (threads // 32 // w)), kce.BLOCKS_PER_SM * sms * kce.THREADS // threads))
        return g if blocks is None else g._replace(blocks=blocks)

    def parent_plan(n, c):
        per_block = kce.THREADS if c is None else kce.WARPS
        return kce.Plan("binary" if c is None else "rows", 1, max(1, min(-(-n // per_block), 2 * sms)), kce.THREADS, 0)

    def cluster_plan(n, c):
        g = shipped_plan(n, c)
        return g._replace(blocks=-(-g.blocks // 8) * 8)

    state_gen = lambda nb: (100.0 * torch.rand((nb,), generator=gen, device="cuda"),  # noqa: E731
                            torch.randint(0, 2**20, (nb,), generator=gen, device="cuda", dtype=torch.int32),
                            torch.randint(0, 2**20, (nb,), generator=gen, device="cuda", dtype=torch.int32))
    shapes = {  # name: (rows, classes, logits)
        "(a) ImageNet batch, probabilities": (cs.BATCH, cs.N_CLASSES, False),
        "(b) ImageNet batch, logits": (cs.BATCH, cs.N_CLASSES, True),
        "last ImageNet batch, logits": (cs.N_SAMPLES % cs.BATCH, cs.N_CLASSES, True),
        "(c) binary batch": (cs.BATCH, None, False),
    }
    rows_shapes = [name for name in shapes if "binary" not in name]
    big = (65_536, cs.N_CLASSES, True)
    # (what, shape name or (rows, classes, logits), variant, plan)
    runs = []
    for name in shapes:  # the split of a call; the binary batch is one block, with no merge tail
        variants = ("shipped", "empty launch")
        if "binary" not in name:
            variants += ("row pass alone", "merge tail alone", "ticket alone", "4 accumulator copies",
                         "16 accumulator copies", "fences by every thread", "thread 0 fences",
                         "ticket alone, fences by every thread", "ticket alone, thread 0 fences")
        runs += [(name, name, variant, shipped_plan) for variant in variants]
        if parent:
            runs.append((name, name, f"parent ({PARENT_COMMIT})", parent_plan))
    for name in rows_shapes:
        for blocks in (128, 256):  # two or four rounds a block at four warps a row: fewer blocks on the ticket
            runs.append((f"{name}, {blocks} blocks", name, "shipped", lambda n, c, b=blocks: shipped_plan(n, c, blocks=b)))
        for w in (1, 2, 4):
            runs.append((f"{name}, {w} warps a row", name, "shipped", lambda n, c, w=w: shipped_plan(n, c, w)))
            runs.append((f"{name}, {w} warps a row", name, "1,024 threads a block",
                         lambda n, c, w=w: shipped_plan(n, c, w, threads=1024)))
    for what, shape in ((rows_shapes[0], rows_shapes[0]), ("65,536 x 1,000 logits", big)):
        runs.append((f"{what}, accumulator", shape, "shipped", shipped_plan))
        runs.append((f"{what}, accumulator", shape, "16 accumulator copies", shipped_plan))
        runs.append((f"{what}, cluster merge", shape, "cluster merge", cluster_plan))
    # the one-block threshold: one block against a grid of a round a block (binary: a score a thread)
    for what, (n, c, logits), grid in [(f"binary {n}", (n, None, False), n // kce.THREADS) for n in (1024, 2048, 4096)] + \
            [(f"{n} rows x 1,000", (n, cs.N_CLASSES, True), -(-n // 2)) for n in (2, 4, 8, 16)] + \
            [(f"{n} short rows (C=3)", (n, 3, True), -(-n // kce.THREADS)) for n in (256, 512, 1024)]:
        for blocks in (1, grid):
            runs.append((f"{what}, {blocks} block(s)", (n, c, logits), "shipped",
                         lambda n_, c_, b=blocks: shipped_plan(n_, c_, blocks=b)))
    for n in (cs.BATCH, cs.N_SAMPLES):
        runs += [(f"binary {n}", (n, None, False), variant, shipped_plan)
                 for variant in ("shipped", "merged-lane adds", "64-bit shared atomics")]
    for name in rows_shapes[:2]:
        runs += [(name, name, "64-bit shared atomics", shipped_plan)]
        for w in (1, 4):  # the argmax of the probabilities: every score divided against the filtered few
            runs += [(f"{name}, {w} warps a row", name, variant, lambda n, c, w=w: shipped_plan(n, c, w))
                     for variant in ("shipped", "every score divided", "the divide filter in a helper")]
    for shape in (big, (cs.N_SAMPLES, cs.N_CLASSES, True)):  # a warp a row, many rows a warp
        runs += [(f"{shape[0]:,} x 1,000 logits", shape, variant, shipped_plan)
                 for variant in ("shipped", "every score divided", "the divide filter in a helper")]

    with tempfile.TemporaryDirectory() as workdir:
        entries = _calibration_libraries(workdir, parent)
        inputs = {}
        for turn in (runs, runs[::-1]):  # forward, then backward
            for what, shape, variant, plan_of in turn:
                n, c, logits = shapes[shape] if isinstance(shape, str) else shape
                if (n, c, logits) not in inputs:
                    preds, target = cs._ce_case(n, c, gen, logits=logits)
                    st = state_gen(cs.CE_BINS + 1)
                    inputs[(n, c, logits)] = (preds, target, st, kce.calibration_bins(*st, preds, target, c))
                preds, target, st, want = inputs[(n, c, logits)]
                g = plan_of(n, c)
                switches = {**CE_DEFAULTS, **CE_VARIANTS.get(variant, {})}
                call, got = _ce_call(entries[variant], variant.startswith("parent"), st, preds, target, c, g.mode,
                                     g.warps_per_row, g.blocks, switches["COPIES"])
                torch.cuda.synchronize()
                if switches["ROWS"] and switches["TAIL"] and not switches["EMPTY"]:  # a whole update: check it
                    cs.check(int(got[2].sum()) == int(want[2].sum()) and
                             torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-6),
                             f"calibration variant {variant} differs ({what}, plan {tuple(g)})")
                key = f"{what}: {variant}, plan {tuple(g)[:3]}"
                rows.setdefault(key, []).append(cs.time_ms(call, flush))
        for key, times in rows.items():
            print(f"[calibration] {key}: {' / '.join(f'{x:.4f}' for x in times)} ms after an L2 flush "
                  f"(forward / backward)", flush=True)
    return rows


WIDTH_ROWS = (848, 1024, 1056, 1057, 1536, 2048, 2112, 3072, 4096, 4224, 4225, 6144, 8192, 16_384, 65_536)


def _widths_library(workdir: str):
    """The shipped source with every width (1, 2 and 4 warps a row) instantiated in its launch switch."""
    src = open(os.path.join(_build.CSRC_DIR, "calibration.cu")).read()
    anchor = "    case 9: calib_rows_long_kernel"
    if src.count(anchor) != 1:
        raise RuntimeError("kernel_ablation: the calibration source changed, cannot place the widths")
    for w in (1, 2, 4):
        line = f"    case {w}: calib_rows_kernel<T, U, {w}><<<blocks, kThreads, smem, stream>>>(a); break;\n"
        if line not in src:
            src = src.replace(anchor, line + anchor)
    path = os.path.join(workdir, "calibration_widths.cu")
    with open(path, "w") as f:
        f.write(src)
    fn = _nvcc_all({"widths": (path, [])})["widths"].calibration_bins_launch
    fn.argtypes = CE_ARGTYPES + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _calibration_widths(flush: torch.Tensor, gen: torch.Generator) -> dict:
    """1, 2 and 4 warps a row at growing batches of 1,000 logits (float32, and float16 at 2,048
    rows), each with the launcher's grid for that width; every update held against the plain
    version as phase 3 holds it. Two turns, forward then backward."""
    ce = importlib.import_module("torchmetrics_tpu_torch.functional.classification.calibration_error")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(n, torch.float32) for n in WIDTH_ROWS] + [(2048, torch.float16)]
    rows = {}
    with tempfile.TemporaryDirectory() as workdir:
        fn = _widths_library(workdir)
        inputs = {}
        for shape in shapes:
            n, dtype = shape
            preds, target = cs._ce_case(n, cs.N_CLASSES, gen, logits=True, dtype=dtype)
            st = tuple(x.clone() for x in ce._zero_bins(cs.CE_BINS, torch.device("cuda")))
            want = ce._calibration_accumulate_plain(st, preds, target, cs.N_CLASSES, None)
            slack = cs._ce_edge_slack(preds, target, cs.N_CLASSES, cs.CE_BINS)
            inputs[shape] = (preds, target, st, want, slack)
        runs = [(shape, w) for shape in shapes for w in (1, 2, 4)]
        for turn in (runs, runs[::-1]):
            for (n, dtype), w in turn:
                preds, target, st, want, slack = inputs[(n, dtype)]
                g = kce.plan(n, cs.N_CLASSES, cs.CE_BINS, sms)
                g = g._replace(warps_per_row=w, blocks=min(-(-n // (kce.WARPS // w)), kce.BLOCKS_PER_SM * sms))
                call, got = _ce_call(fn, False, st, preds, target, cs.N_CLASSES, g.mode, w, g.blocks)
                torch.cuda.synchronize()
                cs._ce_state_check(f"{n} x 1,000 {dtype}, {w} warps a row", got, want, slack)
                key = f"{n:,} x 1,000 {str(dtype)[6:]} logits, {w} warps a row, {g.blocks} blocks"
                rows.setdefault(key, []).append(cs.time_ms(call, flush))
    for key, times in rows.items():
        print(f"[calibration widths] {key}: {' / '.join(f'{x:.4f}' for x in times)} ms after an L2 flush "
              f"(forward / backward)", flush=True)
    return rows


def _edited_builds(source: str, builds: dict, workdir: str, skip_failed: bool = False) -> dict:
    """Build ``{name: (edits, extra nvcc flags)}`` copies of ``csrc/<source>.cu`` at once, each edit
    ``(old, new)`` placed where ``old`` stands once in the source; ``{name: (ctypes.CDLL, ptxas report)}``. With
    ``skip_failed`` a build that fails is reported and left out, else it raises."""
    src = open(os.path.join(_build.CSRC_DIR, f"{source}.cu")).read()
    running = {}
    for name, (edits, extra) in builds.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"kernel_ablation: the {source} source changed, cannot place {old!r}")
            text = text.replace(old, new)
        path = os.path.join(workdir, f"{source}{len(running)}.cu")
        lib = os.path.join(workdir, f"lib{source}{len(running)}.so")
        with open(path, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o", lib, path]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0 and skip_failed:
            print(f"[{source}] build {name!r} failed, left out:\n{log}", flush=True)
            continue
        if proc.returncode != 0:
            raise RuntimeError(f"kernel_ablation: nvcc failed for {name}:\n{log}")
        report = " ".join(l.strip() for l in log.splitlines()
                          if "spill" in l or "registers" in l or "Performance Loss" in l)
        built[name] = (ctypes.CDLL(lib), report)
    return built


def _retrieval_entry(lib: ctypes.CDLL):
    fn = lib.retrieval_groups_launch
    fn.argtypes = krt.ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _retrieval_call(fn, ps, ts, offsets, measure: str, top_k, longest: int, items=None):
    """A call of a build's ``retrieval_groups_launch`` as the launcher makes it (``items``: documents a thread
    in place of the plan's); it returns what the launcher returns."""
    g = krt.plan(longest)
    if items:
        g = g._replace(threads=g.width // items)
    n, groups = ps.shape[0], offsets.shape[0] - 1
    ranked = measure == "ranked"
    out = torch.empty((n if ranked else groups,), device="cuda")
    second = torch.empty((n if ranked else groups,), dtype=torch.int32 if ranked else torch.float32, device="cuda")
    scratch = torch.empty((2 * n,), dtype=torch.int64, device="cuda") if g.long else None

    def call():
        err = fn(ps.data_ptr(), ts.data_ptr(), offsets.data_ptr(), groups, krt.MEASURES[measure],
                 int(top_k is not None), min(top_k or 0, 2**31 - 1), float(top_k or 0), 0, out.data_ptr(),
                 0 if ranked else second.data_ptr(), second.data_ptr() if ranked else 0,
                 0 if scratch is None else scratch.data_ptr(), g.threads, g.shared_bytes,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"kernel_ablation: retrieval launch failed with CUDA error {err}")
        return (second, out) if ranked else (out, second)

    return call


def _msmarco_cases(gen: torch.Generator, measures_at: dict) -> list:
    """MS MARCO's shape laid out by query id, at each relevant share of ``measures_at``:
    ``[(share, measure, ps, ts, offsets, longest)]``."""
    from torchmetrics_tpu_torch.functional.retrieval import kernels as rk

    cases = []
    for share, measures in measures_at.items():
        p, t, i = cs._retrieval_case([cs.MSMARCO_CANDIDATES] * cs.MSMARCO_QUERIES, gen, share)
        ps, ts, offsets, longest = rk.query_layout(p, t, i)
        cases += [(share, m, ps, ts, offsets, longest) for m in measures]
    return cases


RET_WIDTHS = (256, 1024, 4096, 16_384, 100_000)
RET_POSITIVES = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256)
RET_ROWS = 4_000_000  # rows a batch: queries of one width
RET_PATHS = {  # the source with its counting thresholds set so that every query counts, or every query sorts
    "counting": ([("constexpr int kCountShort = 64;", "constexpr int kCountShort = kMaxPositives;"),
                  ("constexpr int kCountLong = 192;", "constexpr int kCountLong = kMaxPositives;")], []),
    "radix sort": ([("constexpr int kCountShort = 64;", "constexpr int kCountShort = -1;"),
                    ("constexpr int kCountLong = 192;", "constexpr int kCountLong = -1;")], []),
}


def _retrieval_batch(n: int, n_pos: int, gen: torch.Generator):
    """``RET_ROWS // n`` queries (at least one) of ``n`` documents in order, each with ``n_pos`` relevant ones."""
    queries = max(1, RET_ROWS // n)
    scores = torch.randn((queries, n), generator=gen, device="cuda")
    target = torch.zeros((queries, n), device="cuda")
    if n_pos:
        picks = torch.rand((queries, n), generator=gen, device="cuda").argsort(dim=1)[:, :n_pos]
        target.scatter_(1, picks, 1.0)
    offsets = torch.arange(queries + 1, device="cuda", dtype=torch.int64) * n
    return scores.reshape(-1).contiguous(), target.reshape(-1).contiguous(), offsets


def _retrieval(flush: torch.Tensor, gen: torch.Generator) -> dict:
    """Counting against sorting at each width and count of relevant documents a query, two turns."""
    rows = {}
    with tempfile.TemporaryDirectory() as workdir:
        fns = {name: _retrieval_entry(lib) for name, (lib, _) in _edited_builds("retrieval", RET_PATHS, workdir).items()}
        for n in RET_WIDTHS:
            for n_pos in RET_POSITIVES:
                if n_pos > n:
                    continue
                preds, target, offsets = _retrieval_batch(n, n_pos, gen)
                for measure, top_k in (("average_precision", None), ("auroc", 10)):
                    got = {}
                    for turn in (0, 1):
                        for path in (fns if turn == 0 else list(fns)[::-1]):
                            call = _retrieval_call(fns[path], preds, target, offsets, measure, top_k, n)
                            got[path] = call()[0].clone()
                            key = f"{n:,} documents, {n_pos} relevant, {measure}@{top_k}, {path}"
                            rows.setdefault(key, []).append(cs.time_ms(call, flush))
                    err = float((got["counting"] - got["radix sort"]).abs().max())
                    cs.check(err <= 1e-6, f"kernel_ablation: the two paths differ by {err} ({n}, {n_pos}, {measure})")
                del preds, target, offsets
    for key, times in rows.items():
        print(f"[retrieval] {key}: {' / '.join(f'{x:.4f}' for x in times)} ms after an L2 flush "
              f"(two turns)", flush=True)
    return rows


RET_OCCUPANCY = (1024, 2048)  # kThreadsAnSm: the threads an SM its registers are sized for


def _retrieval_occupancy(flush: torch.Tensor, gen: torch.Generator) -> dict:
    """The shipped source built for 1,024 and 2,048 threads an SM (64 and 32 registers a thread), each at
    4 and 8 documents a thread (blocks of 256 and 128 threads a query), timed on MS MARCO's shape: the
    counting path (about 1.07 relevant a query) under AP and AUROC, the ranked layout, and the sort path
    (a 0.3 share) under AP."""
    builds = {t: ([("constexpr int kThreadsAnSm = 1024;", f"constexpr int kThreadsAnSm = {t};")], [])
              for t in RET_OCCUPANCY}
    rows = {}
    with tempfile.TemporaryDirectory() as workdir:
        fns = {t: _retrieval_entry(lib) for t, (lib, _) in _edited_builds("retrieval", builds, workdir).items()}
        cases = _msmarco_cases(gen, {cs.MSMARCO_RELEVANT / cs.MSMARCO_CANDIDATES: ("average_precision", "auroc",
                                                                                 "ranked"),
                                     0.3: ("average_precision",)})
        runs = [(t_sm, items) for t_sm in RET_OCCUPANCY for items in (4, 8)]
        for turn in (runs, runs[::-1]):
            for threads_an_sm, items in turn:
                for share, measure, ps, ts, offsets, longest in cases:
                    call = _retrieval_call(fns[threads_an_sm], ps, ts, offsets, measure, None, longest, items)
                    got = call()
                    want = krt.retrieval_groups(ps, ts, offsets, measure, longest=longest)
                    cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                             f"kernel_ablation: the {threads_an_sm}-thread build differs ({measure}, {share})")
                    key = (f"MS MARCO shape, {share:.5f} relevant, {measure}, registers for {threads_an_sm} threads an SM, "
                           f"{items} documents a thread")
                    rows.setdefault(key, []).append(cs.time_ms(call, flush))
    for key, times in rows.items():
        print(f"[retrieval occupancy] {key}: {' / '.join(f'{x:.4f}' for x in times)} ms after an L2 flush "
              f"(two turns)", flush=True)
    return rows


_NO_LONG_PATH = ("    long_query<Layout>(a, g, start, n, smem);\n    return;", "    return;")
_NO_16_WORDS = [("constexpr int kMaxItems = 16;", "constexpr int kMaxItems = 8;"),
                ("    default: short_path<16, Layout>(a, g, start, n, smem); break;", "    default: break;")]
RET_BUILDS = {  # name: (the source text replaced in csrc/retrieval.cu, extra nvcc flags)
    "shipped": ([], []),
    "no 16-word instantiation": (_NO_16_WORDS, []),
    "no long path": ([_NO_LONG_PATH], []),
    "eight ballots for the digit match": ([
        ("    const unsigned peers = __match_any_sync(kFull, d);\n    unsigned* slot = hist + d * warps + warp;",
         "    unsigned peers = kFull;\n#pragma unroll\n    for (int b = 0; b < 8; ++b) {\n"
         "      const unsigned bit = __ballot_sync(kFull, (d >> b) & 1u);\n      peers &= ((d >> b) & 1u) ? bit : ~bit;\n"
         "    }\n    unsigned* slot = hist + d * warps + warp;")], []),
    "neither": (_NO_16_WORDS + [_NO_LONG_PATH], []),
}


def _retrieval_builds(flush: torch.Tensor, gen: torch.Generator) -> dict:
    """The shipped source and builds without its 16-word short path, its long path, or both (wrong for
    the queries those paths take; MS MARCO's take neither), each build's ptxas report printed: how much
    of the register pressure, and of MS MARCO's time, the paths it does not run cost."""
    rows = {}
    with tempfile.TemporaryDirectory() as workdir:
        fns = {}
        for name, (lib, report) in _edited_builds("retrieval", RET_BUILDS, workdir).items():
            print(f"[retrieval builds] {name}: {report}", flush=True)
            fns[name] = _retrieval_entry(lib)
        cases = _msmarco_cases(gen, {cs.MSMARCO_RELEVANT / cs.MSMARCO_CANDIDATES: ("average_precision", "ranked"),
                                     0.3: ("average_precision",)})
        names = list(RET_BUILDS)
        for turn in (names, names[::-1]):
            for name in turn:
                for share, measure, ps, ts, offsets, longest in cases:
                    call = _retrieval_call(fns[name], ps, ts, offsets, measure, None, longest)
                    got = call()
                    want = krt.retrieval_groups(ps, ts, offsets, measure, longest=longest)
                    cs.check(all(torch.equal(a, b) for a, b in zip(got, want)),
                             f"kernel_ablation: the build {name} differs ({measure}, {share})")
                    key = f"MS MARCO shape, {share:.5f} relevant, {measure}, {name}"
                    rows.setdefault(key, []).append(cs.time_ms(call, flush))
    for key, times in rows.items():
        print(f"[retrieval builds] {key}: {' / '.join(f'{x:.4f}' for x in times)} ms after an L2 flush "
              f"(two turns)", flush=True)
    return rows


_POISON = ("  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_words);\n",
           "  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_words);\n"
           "  {\n    unsigned bytes;\n    asm(\"mov.u32 %0, %%dynamic_smem_size;\" : \"=r\"(bytes));\n"
           "    for (unsigned i = threadIdx.x; i < bytes / 4; i += blockDim.x) reinterpret_cast<unsigned*>(smem)[i] = "
           "0x7fc00bad;\n    __syncthreads();\n  }\n")
_REDUX_SUMS = ("    greater = warp_sum(greater);\n    if (keys) {\n      above = warp_sum(above);\n"
               "      equal = warp_sum(equal);",
               "    greater = __reduce_add_sync(kFull, greater);\n    if (keys) {\n"
               "      above = __reduce_add_sync(kFull, above);\n      equal = __reduce_add_sync(kFull, equal);")
_BLOCKS_OF_256 = ("__launch_bounds__(kMaxThreads, kThreadsAnSm / kMaxThreads)", "__launch_bounds__(256, 1)")
_COUNT_OUT_OF_LINE = ("__device__ void count_against(", "__device__ __noinline__ void count_against(")
RET_FAULT_BUILDS = {  # name: (the source text replaced in csrc/retrieval.cu, extra nvcc flags)
    "shipped": ([], []),  # the package's own build: shuffles for the counting path's warp sums
    "reduce_add sums": ([_REDUX_SUMS], []),
    "reduce_add sums + ptxas -O1": ([_REDUX_SUMS], ["-Xptxas", "-O1"]),
    "reduce_add sums + ptxas -O2": ([_REDUX_SUMS], ["-Xptxas", "-O2"]),
    "reduce_add sums + dynamic shared memory poisoned at entry": ([_REDUX_SUMS, _POISON], []),
    # registers for blocks of at most 256 threads (255 a thread, almost no spills): right for queries of up to 4,096
    "reduce_add sums + registers for blocks of 256": ([_REDUX_SUMS, _BLOCKS_OF_256], []),
    "reduce_add sums + count_against out of line": ([_REDUX_SUMS, _COUNT_OUT_OF_LINE], []),
}
RET_FAULT_TRIALS = 20


def _retrieval_fault(builds, trials: int) -> dict:
    """Phase 3's small queries (1 to 64 documents, NaN, +-inf and +-0.0 scores, a 0.4 relevant share) through
    each build of ``RET_FAULT_BUILDS`` named in ``builds``, ``trials`` seeds, against the plain version at
    phase 3's tolerance: the queries whose value differs, for each build and measure (every measure but
    the ranked layout, which some builds leave out)."""
    from torchmetrics_tpu_torch.functional.retrieval import kernels as rk

    version = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True).stdout.strip().splitlines()
    print(f"[retrieval fault] nvcc: {version[-1] if version else 'unknown'}", flush=True)
    bad = {}
    with tempfile.TemporaryDirectory() as workdir:
        chosen = {name: RET_FAULT_BUILDS[name] for name in builds if name != "shipped"}
        fns = {"shipped": krt._launch_fn()} if "shipped" in builds else {}  # the package's own build
        for name, (lib, report) in _edited_builds("retrieval", chosen, workdir).items():
            print(f"[retrieval fault] {name}: {report}", flush=True)
            fns[name] = _retrieval_entry(lib)
        for trial in range(trials):
            gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 1000 + trial)
            p, t, i = cs._retrieval_case([5, 1, 40, 2, 64, 17] * 30, gen, 0.4, ("nonfinite", "none_all"))
            ps, ts, offsets, longest = rk.query_layout(p, t, i)
            plain_rg = rk._rank_groups_plain(p, t, i)
            for measure in cs.RET_MEASURES:
                for top_k in (None, 10):
                    want = rk._retrieval_scores_plain(p, t, i, measure, top_k, False)[0]
                    tol = 1e-6 * want.abs() + (cs._retrieval_terms(plain_rg, top_k) + 4) * 2.0**-24
                    for name, fn in fns.items():
                        got = _retrieval_call(fn, ps, ts, offsets, measure, top_k, longest)()[0]
                        key = f"{name}, {measure}@{top_k}"
                        bad[key] = bad.get(key, 0) + int(((got - want).abs() > tol).sum())
    for key, count in bad.items():
        print(f"[retrieval fault] {key}: {count} queries of {trials * 180} differ from plain", flush=True)
    return bad


SSIM_VARIANTS = {  # name: (the source text replaced in csrc/ssim.cu, the tile's output rows); "shipped" first
    "shipped (8 column rows, 4 row outputs a thread, 2 blocks an SM)": ([], 64),
    "8 row outputs a thread": ([("constexpr int kRowOuts = 4;", "constexpr int kRowOuts = 8;")], 64),
    "4 column rows a thread (32 x 32 tiles)": ([("constexpr int kColRows = 8;", "constexpr int kColRows = 4;")], 32),
    "4 column rows, 3 blocks an SM": ([("constexpr int kColRows = 8;", "constexpr int kColRows = 4;"),
                                       ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 3;")], 32),
    "4 column rows, 8 row outputs, 3 blocks an SM": ([("constexpr int kColRows = 8;", "constexpr int kColRows = 4;"),
                                                      ("constexpr int kRowOuts = 4;", "constexpr int kRowOuts = 8;"),
                                                      ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 3;")],
                                                     32),
    "the tile by loads and stores, no cp.async": ([
        ("      copy_async(s_p + y * in_s + x, prow + gx);\n      copy_async(s_t + y * in_s + x, trow + gx);",
         "      s_p[y * in_s + x] = prow[gx];\n      s_t[y * in_s + x] = trow[gx];")], 64),
    "no column pass (wrong values)": ([("  for (int r = 0; r < kh + kColRows - 1; ++r) {",
                                       "  for (int r = 0; r < 0; ++r) {")], 64),
    "no row pass (wrong values)": ([("  for (int task = t; task < in_h * kSegments; task += kThreads) {",
                                    "  for (int task = in_h * kSegments; task < in_h * kSegments; task += kThreads) {")],
                                   64),
}


def _ssim_libraries(workdir: str) -> dict:
    builds = {name: (edits, []) for name, (edits, _) in SSIM_VARIANTS.items()}
    entries = {}
    for name, (lib, _) in _edited_builds("ssim", builds, workdir).items():
        fn = lib.ssim_window_launch
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, f, f, p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, f, f, ctypes.c_double, i, p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def _ssim(flush: torch.Tensor, gen: torch.Generator) -> dict:
    """Each variant at DIV2K's batch and at MS-SSIM's four smaller scales, two turns."""
    fs = importlib.import_module("torchmetrics_tpu_torch.functional.image.ssim")
    rows = {}
    with tempfile.TemporaryDirectory() as workdir:
        entries = _ssim_libraries(workdir)
        preds, target = cs._image_pair(cs.DIV2K_SHAPE, gen, 0.05)
        scales = [(preds, target)]
        for _ in range(4):
            scales.append(tuple(torch.nn.functional.avg_pool2d(x, 2) for x in scales[-1]))
        taps = fs._window_taps(True, 11, 1.5, torch.device("cuda"))
        names = list(SSIM_VARIANTS)
        for turn in (names, names[::-1]):
            for name in turn:
                _, tile_h = SSIM_VARIANTS[name]
                for level, (p_, t_) in enumerate(scales):
                    b, c, h, w = p_.shape
                    g = kss.plan(b, c, h, w, 11, 11, False)
                    blocks = (g.blocks[0], -(-g.rows // tile_h), g.blocks[2])
                    out = torch.empty((b,), device="cuda")
                    partials = torch.empty((b * c * blocks[0] * blocks[1] * 2,), dtype=torch.float64, device="cuda")
                    ticket = torch.zeros((1,), dtype=torch.int32, device="cuda")
                    count = float(c * (h - 10) * (w - 10))
                    fn = entries[name]

                    def call(fn=fn, p_=p_, t_=t_, out=out, partials=partials, ticket=ticket, g=g, b=b, c=c, h=h,
                             w=w, count=count, tile_h=tile_h):
                        err = fn(p_.data_ptr(), t_.data_ptr(), taps.data_ptr(), taps.data_ptr(), 0, 1e-4, 9e-4,
                                 out.data_ptr(), 0, 0, partials.data_ptr(), ticket.data_ptr(), b, c, h, w, 11, 11,
                                 g.row0, g.col0, g.rows, g.cols, 0, 0.0, 0.0, count,
                                 _ssim_shared(tile_h), torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"kernel_ablation: ssim launch failed with CUDA error {err}")
                        return out

                    got = call().clone()
                    torch.cuda.synchronize()
                    if "wrong" not in name:
                        want = fs._ssim_update(p_, t_, data_range=1.0)
                        cs.check(bool(((got - want).abs() <= 1e-5 * want.abs()).all()),
                                 f"kernel_ablation: ssim variant {name} differs at scale {level}")
                    key = f"scale {level} {tuple(p_.shape)}, {name}"
                    rows.setdefault(key, []).append(cs.time_ms(call, flush, reps=20))
    for key, times in rows.items():
        print(f"[ssim] {key}: {' / '.join(f'{x:.4f}' for x in times)} ms after an L2 flush (two turns)", flush=True)
    return rows


def _ssim_shared(tile_h: int, kh: int = 11, kw: int = 11) -> int:
    """``csrc/ssim.cu``'s ``shared_bytes_for`` at tiles of ``tile_h`` output rows."""
    in_h, in_stride = tile_h + kh - 1, (kss.TILE_W + kw - 1) | 1
    return 8 * kh + 4 * ((kw + 1) & ~1) + 4 * 2 * in_h * in_stride + 4 * 5 * in_h * kss.ROW_STRIDE


# ---------------------------------------------------------------- pairwise_lp
Y_ONE_AT_A_TIME = ("""      float4 yb = *reinterpret_cast<const float4*>(&ys[buf][tx][4 * q]);
#pragma unroll
      for (int j = 0; j < RC; ++j) {
        const float4 yn = *reinterpret_cast<const float4*>(&ys[buf][tx + kColThreads * ((j + 1) % RC)][4 * q]);
        sum_group<KIND, RM, RC, NPOW>(acc, xa, yb, j, int_p, p, s_table);
        yb = yn;  // the next column's four, read before this column's sums
      }""", """#pragma unroll
      for (int j = 0; j < RC; ++j) {
        const float4 yb = *reinterpret_cast<const float4*>(&ys[buf][tx + kColThreads * j][4 * q]);
        sum_group<KIND, RM, RC, NPOW>(acc, xa, yb, j, int_p, p, s_table);
      }""")  # each column's four values read just before its sums
PAIRWISE_PARENT = "e060d72"  # the kernel before the redesign: 64 x 64 tiles, 4 x 4 sums a thread, one stage, powf
PAIRWISE_VARIANTS = {  # name: (the source text replaced in csrc/pairwise.cu, a thread's tile or None: the plan's)
    "shipped": ([], None),
    "8 x 8 sums a thread (128 x 128 tiles)": ([], (8, 8)),
    "4 x 4 sums a thread (64 x 64 tiles, the earlier tile)": ([], (4, 4)),
    "one staged chunk (no double buffering)": ([("constexpr int kStages = 2;", "constexpr int kStages = 1;")], None),
    "chunks of 16 columns": ([("constexpr int kChunk = 32;", "constexpr int kChunk = 16;")], None),
    "4 x 4 integer kinds at two blocks an SM": ([("(KIND == kIntPow && NPOW == 0) || RC == 4 ? 1",
                                                  "(KIND == kIntPow && NPOW == 0) ? 1")], None),
    "8 x 8 integer kinds at one block an SM": ([("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;")],
                                               None),
    "y read one column at a time": ([Y_ONE_AT_A_TIME], None),
    "accurate powf for every pair": ([("    const bool fast = e >= 1", "    const bool fast = false && e >= 1")], None),
}
PAIRWISE_KINDS = ((1, None), (2, "pow"), (3, "pow"), (1.5, "pow"))


def _pairwise_libraries(workdir: str, parent) -> dict:
    builds = {name: (edits, []) for name, (edits, _) in PAIRWISE_VARIANTS.items()}
    entries, reports = {}, {}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (lib, report) in _edited_builds("pairwise", builds, workdir).items():
        fn = lib.pairwise_lp_launch
        fn.argtypes = [p, p, p, i, i, i, i, i, f, i, f, i, i, p]
        fn.restype = ctypes.c_int
        entries[name], reports[name] = fn, report
    if parent:
        old = os.path.join(workdir, "parent", "pairwise.cu")
        os.makedirs(os.path.dirname(old))
        shutil.copy(os.path.join(parent, "torchmetrics_tpu_torch", "csrc", "pairwise.cu"), old)
        fn = _nvcc_all({"parent": (old, [])})["parent"].pairwise_lp_launch
        fn.argtypes = [p, p, p, i, i, i, i, i, f, i, f, p]  # no rows a thread
        fn.restype = ctypes.c_int
        entries[f"parent ({PAIRWISE_PARENT})"] = fn
    return entries, reports


def _sass_loops(lib_path: str, sass_path) -> dict:
    """The instructions of each kernel's innermost sum loop (the body between its label and its backward branch,
    inside the chunk's barriers), by mnemonic; the whole SASS is written to ``sass_path`` when given."""
    sass = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass", lib_path],
                          capture_output=True, text=True, check=True).stdout
    if sass_path:
        with open(sass_path, "w") as f:
            f.write(sass)
    loops = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split()[0]
        code = [(int(m.group(1), 16), m.group(2)) for m in
                (re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line) for line in block.splitlines()) if m]
        bars = [k for k, (_, ins) in enumerate(code) if ins.startswith("BAR.SYNC")]
        if len(bars) < 2:
            continue
        lo, hi = bars[0], bars[1]
        back = [(k, int(t.group(1), 16)) for k in range(lo, hi)
                for t in [re.search(r"BRA (?:\S+, )?0x([0-9a-f]+)", code[k][1])] if t and int(t.group(1), 16) < code[k][0]]
        if back:
            k, target = back[-1]
            body = [ins for addr, ins in code[lo:k + 1] if addr >= target]
        else:
            body = [ins for _, ins in code[lo:hi]]
        ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].split(".")[0] for ins in body)
        loops[name] = dict(ops.most_common())
    return loops


def _pairwise(flush: torch.Tensor, gen: torch.Generator, parent, sass_path) -> dict:
    """Every variant, the kernel before the redesign (``--parent``) and the shipped build at Market-1501's shape and at
    1,024 x 1,024 x 512, each under phase 3's check against the plain version, in two turns."""
    rows = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as workdir:
        entries, reports = _pairwise_libraries(workdir, parent)
        for name, report in reports.items():
            print(f"[pairwise] build {name!r}: {report}", flush=True)
        _build.build(["pairwise"])
        loops = _sass_loops(str(_build.library_path("pairwise")), sass_path)
        for name, ops in loops.items():
            print(f"[pairwise] SASS of {name}: sum loop {sum(ops.values())} instructions {ops}", flush=True)
        shapes = {"1,024 x 1,024 x 512": (1024, 1024, 512, torch.randn),
                  "Market-1501 (3,368 x 19,732 x 2,048)": (cs.MARKET_QUERY, cs.MARKET_GALLERY, cs.MARKET_WIDTH,
                                                          torch.rand)}
        for label, (n, m, d, draw) in shapes.items():
            x = draw((n, d), generator=gen, device="cuda")
            y = draw((m, d), generator=gen, device="cuda")
            out = torch.empty((n, m), device="cuda")
            reps = 3 if n * m * d > 2**32 else 10
            for p, root in PAIRWISE_KINDS:
                want = kpw._pairwise_lp_plain(x, y, p, root)
                sums = want.double().pow(float(p)) if root == "pow" else want.double()  # every term is >= 0
                inv_p = torch.tensor(1.0 / p, dtype=torch.float32).item()
                kind, int_p = kpw.KINDS[kpw._kind(p)], int(p) if isinstance(p, int) else 0
                runs = []
                for name, fn in entries.items():
                    if name.startswith("accurate") and isinstance(p, int):
                        continue
                    if name.startswith("parent"):
                        args = (x.data_ptr(), y.data_ptr(), out.data_ptr(), n, m, d, kind, int_p, float(p),
                                kpw.ROOTS[root], inv_p)
                    else:
                        tile = PAIRWISE_VARIANTS[name][1] or kpw.tile(n, m, p, sms)
                        args = (x.data_ptr(), y.data_ptr(), out.data_ptr(), n, m, d, kind, int_p, float(p),
                                kpw.ROOTS[root], inv_p, *tile)

                    def call(fn=fn, args=args):
                        err = fn(*args, torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"kernel_ablation: pairwise launch failed with CUDA error {err}")
                        return out

                    call()
                    torch.cuda.synchronize()
                    cs._lp_check(f"{label}, p={p!r}, {name}", out, want, x, y, p, root, sums)
                    runs.append((name, call))
                for turn in (runs, runs[::-1]):
                    for name, call in turn:
                        key = f"{label}, p={p!r}: {name}"
                        rows.setdefault(key, []).append(cs.time_ms(call, flush, reps=reps, warmup=1))
                bound_ms, by = cs._lp_bound_ms(n, m, d, p)
                for name, _ in runs:
                    key = f"{label}, p={p!r}: {name}"
                    print(f"[pairwise] {key}: {' / '.join(f'{t:.4f}' for t in rows[key])} ms after an L2 flush "
                          f"(two turns), bound {bound_ms:.4f} ms ({by})", flush=True)
                del want, sums
            del x, y, out
    print(f"[pairwise] SM clock, now and at most: {cs.sm_clocks()}", flush=True)
    return rows


SDR_PARENT = "26973ba"  # the kernel before the redesign: Levinson, one warp a system, two dot products a step
_SDR_ENTRIES = "constexpr int kMinEntries = 4;     // slots a thread, at least"
_SDR_RECIPROCAL = "__device__ __forceinline__ double reciprocal(double v) { return 1.0 / v; }"
_SDR_NEWTON = ("__device__ __forceinline__ double reciprocal(double v) {\n"
               "  double r;\n"
               '  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(v));\n'
               "  double e = fma(-v, r, 1.0);\n"
               "  r = fma(r, e, r);\n"
               "  e = fma(-v, r, 1.0);\n"
               "  return fma(r, e, r);\n"
               "}")
_SDR_WIDTH = "constexpr int kBlockThreads = E <= 2 ? kMaxThreads : kMaxThreads / 2;"
_SDR_SCALED = ("    const double mu = now[0] * inv_beta;\n"
               "    const double gamma = more ? now[1] * inv_beta : 0.0;\n")
# the timing-only builds record the SM cycles of the steps in x[row, 0] (their values are wrong)
_SDR_CYCLES = [("  double beta = 1.0, inv_beta = 1.0;\n",
                "  double beta = 1.0, inv_beta = 1.0;\n  const long long t_loop = clock64();\n"),
               ("    sdr[blockIdx.x] = static_cast<float>(10.0 * log10(total / (1.0 - total)));\n",
                "    sdr[blockIdx.x] = static_cast<float>(10.0 * log10(total / (1.0 - total)));\n"
                "    x_out[row] = static_cast<float>(static_cast<double>(clock64() - t_loop) / length);\n")]
_SDR_LEFT = ("    double left = __shfl_up_sync(0xffffffffu, B[E - 1], 1);\n"
             "    if (lane == 0) left = warp > 0 ? edge[k & 1][warp - 1] : 0.0;\n")
SDR_VARIANTS = {  # name: the source text replaced in csrc/sdr_toeplitz.cu; "shipped" first
    "shipped": [],
    **{f"at least {e} slots a thread": [(_SDR_ENTRIES, _SDR_ENTRIES.replace("= 4;", f"= {e};"))]
       for e in (1, 2, 8, 16)},
    "beta's reciprocal by rcp.approx and two Newton steps": [(_SDR_RECIPROCAL, _SDR_NEWTON)],
    **{f"rcp.approx and two Newton steps, at least {e} slots a thread": [
        (_SDR_RECIPROCAL, _SDR_NEWTON), (_SDR_ENTRIES, _SDR_ENTRIES.replace("= 4;", f"= {e};"))] for e in (1, 2)},
    "mu and gamma by IEEE division in the chain": [(_SDR_SCALED, _SDR_SCALED.replace(" * inv_beta", " / beta"))],
    **{f"blocks of up to 1,024 threads at up to {e} slots a thread": [
        (_SDR_WIDTH, _SDR_WIDTH.replace("E <= 2", f"E <= {e}"))] for e in (4, 8)},
    "timing only: cycles a step": _SDR_CYCLES,
    "timing only: cycles a step, no slot updates": [*_SDR_CYCLES, (
        "    for (int e = E - 1; e >= 0; --e) {", "    for (int e = E - 1; e >= 0 && k < 0; --e) {")],
    "timing only: cycles a step, no shift exchange": [*_SDR_CYCLES, (_SDR_LEFT, "    double left = 0.0;\n")],
    "timing only: cycles a step, no reciprocal": [*_SDR_CYCLES, (_SDR_RECIPROCAL, _SDR_RECIPROCAL.replace(
        "return 1.0 / v;", "return v;"))],
}
SDR_SHAPES = (("Libri2Mix batch, 32 x L=512", "speech", 2 * cs.LIBRI_BATCH, cs.LIBRI_SAMPLES, cs.SDR_FILTER),
              ("PIT(SDR)'s tile, 64 x L=512", "speech", 4 * cs.LIBRI_BATCH, cs.LIBRI_SAMPLES, cs.SDR_FILTER),
              ("32 x L=64", "speech", 32, 8000, 64),
              ("2 x L=8192", "white", 2, 2 * 8192, 8192))
# Dependent chains timed by clock64 in one block: fp64 fused multiply-adds, IEEE reciprocals, rcp.approx with two
# Newton steps, block barriers, and the least step of the recursion (a barrier, a broadcast read from shared memory,
# a fused multiply-add, one thread's write of the next step's word).
MICRO_SOURCE = r"""
#include <cuda_runtime.h>
__device__ __forceinline__ double newton(double v) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(v));
  double e = fma(-v, r, 1.0);
  r = fma(r, e, r);
  e = fma(-v, r, 1.0);
  return fma(r, e, r);
}
__global__ void micro(int which, int n, double a, double* out, long long* cycles) {
  __shared__ double word[2];
  double v = a;
  if (threadIdx.x == 0) word[0] = word[1] = a;
  __syncthreads();
  const long long t0 = clock64();
  if (which == 0) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) v = fma(v, a, 1e-3);
  } else if (which == 1) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) v = 1.0 / v;
  } else if (which == 2) {
#pragma unroll 8
    for (int i = 0; i < n; ++i) v = newton(v);
  } else if (which == 3) {
    for (int i = 0; i < n; ++i) __syncthreads();
  } else {
    for (int i = 0; i < n; ++i) {
      __syncthreads();
      v = fma(word[i & 1], a, 1e-3);
      if (threadIdx.x == 0) word[(i & 1) ^ 1] = v;
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = v;
    cycles[0] = t1 - t0;
  }
}
extern "C" int micro_launch(int which, int threads, int n, double a, void* out, void* cycles) {
  micro<<<1, threads>>>(which, n, a, static_cast<double*>(out), static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}
"""
MICRO_KINDS = ("fp64 fma", "fp64 IEEE reciprocal", "fp64 rcp.approx + 2 Newton steps", "block barrier",
               "least step (barrier, shared read, fma, write)")


def _sdr_micro(workdir: str) -> dict:
    """Cycles an operation of each ``MICRO_KINDS`` chain, the barriers at blocks of 32 to 1,024 threads."""
    path = os.path.join(workdir, "micro.cu")
    with open(path, "w") as f:
        f.write(MICRO_SOURCE)
    fn = _nvcc_all({"micro": (path, [])})["micro"].micro_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(1, dtype=torch.float64, device="cuda")
    cycles = torch.empty(1, dtype=torch.int64, device="cuda")
    record = {}
    for which, kind in enumerate(MICRO_KINDS):
        for threads in ((32,) if which < 3 else (32, 128, 512, 1024)):
            per_op = []
            for n in (1024, 4096):  # the difference of two lengths: the loop's entry and exit drop out
                runs = []
                for _ in range(5):
                    err = fn(which, threads, n, 1.0000001, out.data_ptr(), cycles.data_ptr())
                    if err:
                        raise RuntimeError(f"kernel_ablation: micro launch failed with CUDA error {err}")
                    torch.cuda.synchronize()
                    runs.append(int(cycles.item()))
                per_op.append(min(runs))
            key = f"{kind}, {threads} threads"
            record[key] = (per_op[1] - per_op[0]) / (4096 - 1024)
            print(f"[sdr] micro: {key}: {record[key]:.1f} cycles an operation", flush=True)
    return record


def _sdr(flush: torch.Tensor, gen: torch.Generator, parent) -> dict:
    """Every variant of ``sdr_toeplitz`` and, with ``parent``, the kernel before the redesign at the main path's
    shapes, a short and the longest filter, each held against a float64 LU as phase 3 holds the shipped build, in
    two turns; then the micro chains that give the least-chain bound."""
    rows = {}
    p = ctypes.c_void_p
    with tempfile.TemporaryDirectory() as workdir:
        entries = {}
        for name, (lib, report) in _edited_builds("sdr_toeplitz", {k: (v, []) for k, v in SDR_VARIANTS.items()},
                                                  workdir).items():
            entries[name] = lib.sdr_toeplitz_launch
            print(f"[sdr] build {name!r}: {report}", flush=True)
        if parent:
            old = os.path.join(workdir, "parent", "sdr_toeplitz.cu")
            os.makedirs(os.path.dirname(old))
            shutil.copy(os.path.join(parent, "torchmetrics_tpu_torch", "csrc", "sdr_toeplitz.cu"), old)
            entries[f"parent ({SDR_PARENT}): Levinson, one warp a system"] = \
                _nvcc_all({"parent": (old, [])})["parent"].sdr_toeplitz_launch
        for fn in entries.values():
            fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_int, p]
            fn.restype = ctypes.c_int
        for label, kind, n_rows, samples, length in SDR_SHAPES:
            r_0, b = cs._sdr_correlations(gen, kind, n_rows, samples, length)
            exact, _ = ksdr._sdr_toeplitz_plain(r_0.double(), b.double())
            sdr = torch.empty((n_rows,), device="cuda")
            x = torch.empty((n_rows, length), device="cuda")
            runs = []
            for name, fn in entries.items():
                def call(fn=fn):
                    err = fn(r_0.data_ptr(), b.data_ptr(), sdr.data_ptr(), x.data_ptr(), n_rows, length,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"kernel_ablation: sdr_toeplitz launch failed with CUDA error {err}")

                call()
                torch.cuda.synchronize()
                first = sdr.clone()
                call()
                torch.cuda.synchronize()
                if name.startswith("timing only"):  # wrong values; x[0, 0] holds the cycles a step
                    rows.setdefault(f"{label}: {name}: cycles a step", []).append(float(x[0, 0]))
                    print(f"[sdr] {label}: {name}: {float(x[0, 0]):.1f} SM cycles a step (block 0)", flush=True)
                else:
                    err64 = float((sdr.double() - exact).abs().max())
                    backward = cs._backward_error(r_0, b, x)
                    cs.check(err64 <= cs.SDR64_DB and backward <= cs.X_BACKWARD_BOUND and torch.equal(first, sdr),
                             f"[sdr] {label}, {name}: {err64:.3g} dB from float64, backward error {backward:.3g}, "
                             f"deterministic {torch.equal(first, sdr)}")
                runs.append((name, call))
            reps = 3 if length > 4096 else 10
            for turn in (runs, runs[::-1]):
                for name, call in turn:
                    rows.setdefault(f"{label}: {name}", []).append(cs.time_ms(call, flush, reps=reps, warmup=1))
            chain_ms, least_ms = cs._sdr_chain_bound_ms(length), cs._sdr_least_chain_ms(length)
            for name, _ in runs:
                key = f"{label}: {name}"
                print(f"[sdr] {key}: {' / '.join(f'{t:.4f}' for t in rows[key])} ms after an L2 flush (two turns), "
                      f"{1e6 * min(rows[key]) / max(length - 1, 1):.1f} ns a step; Levinson's chain bound "
                      f"{chain_ms:.4f} ms, the least chain {least_ms:.4f} ms", flush=True)
            del r_0, b, exact, sdr, x
        rows["micro cycles"] = _sdr_micro(workdir)
    print(f"[sdr] SM clock, now and at most: {cs.sm_clocks()}", flush=True)
    return rows


SNR_PARENT = SDR_PARENT  # the kernel before the redesign: partials of every chunk, fences and a ticket
_SNR_LOADS = "constexpr int kLoads = 8;"
_SNR_CLUSTER = "constexpr int kCluster = 8;"
_SNR_TMA_HELPER = r"""constexpr int kStages = 4;
constexpr int kTile = kThreads * 4;  // floats of a row a stage: one float4 a thread

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One row pair by bulk copies (TMA) into a ring of kStages tiles, each completing on its mbarrier.
__device__ __forceinline__ void tma_rows(const float* __restrict__ preds, const float* __restrict__ target,
                                         long long begin, long long end, double (&acc)[5]) {
  __shared__ alignas(128) float ring[kStages][2][kTile];
  __shared__ alignas(8) unsigned long long bars[kStages];
  const int tiles = static_cast<int>((end - begin + kTile - 1) / kTile);
  auto issue = [&](int i) {
    const int s = i % kStages;
    const long long off = begin + static_cast<long long>(i) * kTile;
    const unsigned bytes = static_cast<unsigned>(min(static_cast<long long>(kTile), end - off) * 4);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(smem_addr(&bars[s])), "r"(2 * bytes)
                 : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 :: "r"(smem_addr(ring[s][0])), "l"(preds + off), "r"(bytes), "r"(smem_addr(&bars[s])) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 :: "r"(smem_addr(ring[s][1])), "l"(target + off), "r"(bytes), "r"(smem_addr(&bars[s])) : "memory");
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&bars[s])) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < min(tiles, kStages); ++i) issue(i);
  }
  for (int i = 0; i < tiles; ++i) {
    const int s = i % kStages;
    const unsigned parity = (i / kStages) & 1;
    unsigned done = 0;
    while (!done) {
      asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                   " selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(smem_addr(&bars[s])), "r"(parity) : "memory");
    }
    if (begin + static_cast<long long>(i) * kTile + 4 * threadIdx.x < end) {
      const float4 pv = reinterpret_cast<const float4*>(ring[s][0])[threadIdx.x];
      const float4 tv = reinterpret_cast<const float4*>(ring[s][1])[threadIdx.x];
      const float ps[4] = {pv.x, pv.y, pv.z, pv.w}, ts[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const double p = ps[m], t = ts[m];
        acc[0] = fma(p, t, acc[0]);
        acc[2] += t;
        acc[4] = fma(t, t, acc[4]);
        acc[1] += p;
        acc[3] = fma(p, p, acc[3]);
      }
    }
    __syncthreads();  // stage s read by every thread before it is refilled
    if (threadIdx.x == 0 && i + kStages < tiles) issue(i + kStages);
  }
}

template <int S, bool kVec>
__device__ __forceinline__ void accumulate("""
_SNR_TMA = [("template <int S, bool kVec>\n__device__ __forceinline__ void accumulate(", _SNR_TMA_HELPER),
            ("  if constexpr (kVec) {\n    // a batch:",
             "  if constexpr (kVec && S == 1) {\n    tma_rows(preds, target, begin, end, acc);\n"
             "  } else if constexpr (kVec) {\n    // a batch:")]
_SNR_ALWAYS_SECOND = [("  if (static_cast<long long>(group) * chunks <= kCluster) return dim3(group, chunks, 1);\n",
                       "")]
_SNR_PULL = """  cluster.sync();
  const bool first = cluster.block_rank() == 0;
  if (first) {
    for (int k = threadIdx.x; k < units_in * N; k += kThreads) {
      const int ux = k / N, s = k % N;
      double v = 0.0;
      for (int cy = 0; cy < chunks_in; ++cy) v += cluster.map_shared_rank(block_sums, ux + cy * units_in)[s];
      merged[k] = v;
    }
  }
  cluster.sync();
  if (!first) return;
"""
_SNR_PUSH = """  const int rank = static_cast<int>(cluster.block_rank());
  if (threadIdx.x < N) cluster.map_shared_rank(gathered, 0)[rank * N + threadIdx.x] = block_sums[threadIdx.x];
  cluster.sync();
  const bool first = rank == 0;
  if (!first) return;
  for (int k = threadIdx.x; k < units_in * N; k += kThreads) {
    const int ux = k / N, s = k % N;
    double v = 0.0;
    for (int cy = 0; cy < chunks_in; ++cy) v += gathered[(ux + cy * units_in) * N + s];
    merged[k] = v;
  }
  __syncthreads();
"""
_SNR_MERGED = ("  __shared__ double merged[kCluster * N];    // the first block: the cluster's sums of each of its "
               "units\n")
SNR_VARIANTS = {  # name: (the source text replaced in csrc/snr_moments.cu, the plan's constants); "shipped" first
    "shipped": ([], {}),
    **{f"{n} loads a row a thread": ([(_SNR_LOADS, f"constexpr int kLoads = {n};")], {"LOADS": n}) for n in (2, 4, 16)},
    **{f"clusters of {n}": ([(_SNR_CLUSTER, f"constexpr int kCluster = {n};")], {"CLUSTER": n}) for n in (4, 16)},
    "the register batch as a TMA ring (4 stages, one rows mode tile a thread a stage)": (_SNR_TMA, {}),
    "no cluster merge: partials, fences and a ticket for every chunk": (_SNR_ALWAYS_SECOND, {"CLUSTER": 1}),
    "the first block reads its peers' sums after a cluster barrier, a second one keeps them": (
        [(_SNR_PUSH, _SNR_PULL)], {}),
    **{f"the plan at {n} blocks an SM": ([], {"BLOCKS_PER_SM": n}) for n in (4, 8)},
    "4 loads a row a thread, the plan at 4 blocks an SM": ([(_SNR_LOADS, "constexpr int kLoads = 4;")],
                                                           {"LOADS": 4, "BLOCKS_PER_SM": 4}),
}
SNR_SHAPES = (  # (label, shape, mode, scale_invariant, zero_mean)
    ("(a) Libri2Mix batch, SI-SNR rows", (cs.LIBRI_BATCH, 2, cs.LIBRI_SAMPLES), "rows", True, True),
    ("(b) Libri2Mix batch, PIT(SI-SNR) pairs", (cs.LIBRI_BATCH, 2, cs.LIBRI_SAMPLES), "pairs", True, True),
    ("SA-SDR groups of the Libri2Mix batch", (cs.LIBRI_BATCH, 2, cs.LIBRI_SAMPLES), "group", True, False),
    ("(c) one 10-minute 16 kHz clip", (1, 1, 600 * 16_000), "rows", True, True),
)


def _snr_plan(units, length, sms, group, speakers, overrides, parent):
    """The shipped plan with a variant's constants, or, for the parent, its own (chunks of at least 4,096 positions,
    8 blocks an SM, no cluster)."""
    from torchmetrics_tpu_torch.kernels import snr_moments as ksnr

    if parent:
        chunks = max(1, min(length // 4096, -(-8 * sms // units), 65_535))
        chunk = max(4, -(-(-(-length // chunks)) // 4) * 4)
        return ksnr.Plan(chunk, max(1, -(-length // chunk)), 1, 1)
    saved = {k: getattr(ksnr, k) for k in overrides}
    try:
        for k, v in overrides.items():
            setattr(ksnr, k, v)
        ksnr.plan.cache_clear()
        return ksnr.plan(units, length, sms, group, speakers)
    finally:
        for k, v in saved.items():
            setattr(ksnr, k, v)
        ksnr.plan.cache_clear()


def _snr(flush: torch.Tensor, gen: torch.Generator, parent) -> dict:
    """Every variant of ``snr_moments`` and, with ``parent``, the kernel before the redesign at the main path's batch
    shapes and the 10-minute clip, each held against a float64 evaluation as phase 3 holds the shipped build and
    deterministic, in two turns."""
    from torchmetrics_tpu_torch.kernels import snr_moments as ksnr

    rows = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    with tempfile.TemporaryDirectory() as workdir:
        entries = {}
        built = _edited_builds("snr_moments", {k: (v[0], []) for k, v in SNR_VARIANTS.items()}, workdir,
                               skip_failed=True)
        for name, (lib, report) in built.items():
            entries[name] = (lib.snr_moments_launch, SNR_VARIANTS[name][1], False)
            print(f"[snr] build {name!r}: {report}", flush=True)
        if parent:
            old = os.path.join(workdir, "parent", "snr_moments.cu")
            os.makedirs(os.path.dirname(old))
            shutil.copy(os.path.join(parent, "torchmetrics_tpu_torch", "csrc", "snr_moments.cu"), old)
            entries[f"parent ({SNR_PARENT}): partials of every chunk, fences and a ticket"] = (
                _nvcc_all({"parent": (old, [])})["parent"].snr_moments_launch, {}, True)
        for fn, _, _ in entries.values():
            fn.argtypes = [p, p, p, p, p, ll, ll, ll, i, i, i, i, i, p]
            fn.restype = ctypes.c_int
        for label, shape, mode, si, zm in SNR_SHAPES:
            target = cs._speech_like(gen, shape, cs.LIBRI_FS)
            preds = cs._mix_estimates(gen, target, 5.0, 15.0)
            if mode != "pairs":
                preds, target = preds.reshape(-1, shape[-1]), target.reshape(-1, shape[-1])
            group = shape[1] if mode == "group" else 1
            speakers = shape[1] if mode == "pairs" else 1
            units, length = preds.shape[0], preds.shape[-1]
            exact = cs._snr_float64(preds, target, si, zm, group, mode == "pairs")
            out = torch.empty(exact.shape, device="cuda")
            tickets = torch.zeros(units, dtype=torch.int32, device="cuda")
            n_sums = speakers * speakers + 4 * speakers
            runs = []
            for name, (fn, overrides, is_parent) in entries.items():
                if "TMA" in name and mode == "pairs":
                    continue
                g = _snr_plan(units, length, sms, group, speakers, overrides, is_parent)
                partials = torch.empty(units * g.chunks * n_sums, dtype=torch.float64, device="cuda")

                def call(fn=fn, g=g, partials=partials):
                    err = fn(preds.data_ptr(), target.data_ptr(), out.data_ptr(), partials.data_ptr(),
                             tickets.data_ptr(), units, length, g.chunk, g.chunks, speakers, group, int(si), int(zm),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"kernel_ablation: snr_moments launch failed with CUDA error {err}")

                call()
                torch.cuda.synchronize()
                first = out.clone()
                call()
                torch.cuda.synchronize()
                cs._db_check(f"[snr] {label}, {name} against float64", out, exact, cs.SNR64_ATOL_DB, cs.SNR64_RTOL)
                cs.check(torch.equal(first, out), f"[snr] {label}, {name}: not deterministic")
                runs.append((name, call, g))
            for turn in (runs, runs[::-1]):
                for name, call, _ in turn:
                    rows.setdefault(f"{label}: {name}", []).append(cs.time_ms(call, flush))
            bound_us = (2 * preds.numel() + exact.numel()) * 4 / cs.PEAK_BYTES_PER_S * 1e6
            for name, _, g in runs:
                key = f"{label}: {name}"
                print(f"[snr] {key}: {' / '.join(f'{t:.4f}' for t in rows[key])} ms after an L2 flush (two turns); "
                      f"plan {tuple(g)}; bytes bound {bound_us:.2f} us", flush=True)
            del preds, target, exact, out
    print(f"[snr] SM clock, now and at most: {cs.sm_clocks()}", flush=True)
    return rows


BERT_PARENT = "46523d4"
BERT_PRODUCTS = """        Wgmma<N>::run(acc, al, bh);
        Wgmma<N>::run(acc, ah, bl);
        Wgmma<N>::run(acc, ah, bh);"""
BERT_COPY = 'asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\\n" ::"r"(d), "l"(src), "r"(in ? 16 : 0));'
BERT_VARIANTS = {  # name: (edits, checked against the plain version)
    "shipped": ([], True),
    "the split by cvt.rna.tf32.f32": ([(
        "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
        "  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;",
        '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));\n'
        '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));')], True),
    "the prediction rows always wgmma's rows": ([(
        "      const bool swap = (nc + 63) / 64 * ((nr + 31) / 32) < (nr + 63) / 64 * ((nc + 31) / 32);",
        "      const bool swap = false;")], True),
    "no 256-byte L2 fetch": ([(BERT_COPY, BERT_COPY.replace(".L2::256B", ""))], True),
    "three stages": ([("constexpr int kStages = 4;", "constexpr int kStages = 3;")], True),
    "one TF32 pass (timing only)": ([(BERT_PRODUCTS, "        Wgmma<N>::run(acc, ah, bh);")], False),
    "copies alone (timing only)": ([(BERT_PRODUCTS, ""),
                                    ("  if (has_row) split_rows(s, 0, on_target, my_row, ss);", ""),
                                    ("    if (has_row && c + 1 < chunks) split_rows(s, c + 1, on_target, my_row, ss);",
                                     "")], False),
    "no copies (timing only)": ([("  if (c < chunks) {\n    float* stage = s.stages + (c % kStages) * kStageFloats;",
                                  "  if (false) {\n    float* stage = s.stages + (c % kStages) * kStageFloats;")], False),
}
BERT_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int] + \
    [ctypes.c_void_p] * 4  # the launcher's: pred, tgt, masks, weights, B, Tp, Tt, H, P, R, F1, stream


def _bert(flush: torch.Tensor, parent) -> dict:
    """Every variant of ``bert_greedy_match`` and, with ``parent``, the kernel before the redesign at phase 3's case
    (a) and at H = 16 (its lengths: the fixed cost of a pair), each build's ptxas report printed, each checked
    against the plain version (and the shipped build's bits) and launched twice for determinism; timed after a
    flush in turns, forward then backward (parent, new, new, parent), and back to back."""
    from torchmetrics_tpu_torch.kernels import bert_match as kbm

    rows = {}
    t_max = cs.WMT16_MAX_TOKENS
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 51)  # phase 3's seed: its case (a)
    cases = {"(a)": cs._bert_case(gen, cs.WMT16_PAIRS, t_max, t_max, 1_024, (10, t_max))[:4]}
    pe, pm, te, tm = cases["(a)"]
    cases["(a) at H = 16"] = (pe[..., :16].contiguous(), pm, te[..., :16].contiguous(), tm)
    cs._no_tf32()
    wants = {label: torch.stack(kbm._bert_greedy_match_plain(*x)) for label, x in cases.items()}
    with tempfile.TemporaryDirectory() as workdir:
        builds = _edited_builds("bert_match", {k: (v[0], []) for k, v in BERT_VARIANTS.items()}, workdir)
        entries = {name: (lib, report, BERT_VARIANTS[name][1]) for name, (lib, report) in builds.items()}
        if parent:
            old = os.path.join(workdir, "parent", "bert_match.cu")
            os.makedirs(os.path.dirname(old))
            shutil.copy(os.path.join(parent, "torchmetrics_tpu_torch", "csrc", "bert_match.cu"), old)
            proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", old[:-3] + ".so", old],
                                  capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"kernel_ablation: nvcc failed for the parent:\n{proc.stdout}{proc.stderr}")
            report = " ".join(l.strip() for l in (proc.stdout + proc.stderr).splitlines()
                              if "spill" in l or "registers" in l)
            entries[f"parent ({BERT_PARENT})"] = (ctypes.CDLL(old[:-3] + ".so"), report, True)
        runs = []
        for name, (lib, report, checked) in entries.items():
            print(f"[bert] build {name!r}: {report}", flush=True)
            fn = lib.bert_match_launch
            fn.argtypes = BERT_ARGTYPES
            fn.restype = ctypes.c_int

            def call(a, b, c, d, fn=fn):
                out = torch.empty((3, a.shape[0]), device="cuda")
                err = fn(a.data_ptr(), c.data_ptr(), b.data_ptr(), d.data_ptr(), None, None, a.shape[0], a.shape[1],
                         c.shape[1], a.shape[2], out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"kernel_ablation: bert_match launch failed with CUDA error {err}")
                return out

            for label, args in cases.items():
                first, again = call(*args), call(*args)
                torch.cuda.synchronize()
                err = float((first - wants[label]).abs().max())
                same = torch.equal(first.view(torch.int32), again.view(torch.int32))
                if checked:
                    cs.check(err <= cs.BERT_ATOL and same, f"[bert] {name}, {label}: {err:.3g} from plain")
                if name == "shipped":
                    rows[f"shipped bits, {label}"] = first
                elif checked and name != f"parent ({BERT_PARENT})":
                    equal = torch.equal(first.view(torch.int32), rows[f"shipped bits, {label}"].view(torch.int32))
                    print(f"[bert] {name}, {label}: bit for bit the shipped build's: {equal}", flush=True)
                runs.append((name, label, call, args, err))
        for key in [k for k in rows if k.startswith("shipped bits")]:
            del rows[key]
        order = sorted(runs, key=lambda r: not r[0].startswith("parent"))  # the parent first: parent, new, new, parent
        for turn in (order, order[::-1]):
            for name, label, call, args, _ in turn:
                rows.setdefault(f"{name}, {label}, after a flush", []).append(cs.time_ms(lambda: call(*args), flush))
        for name, label, call, args, _ in order:
            a, b, c, d = args
            sets = [args] + [(a.clone(), b, c.clone(), d) for _ in range(cs.copies_for(4 * (a.numel() + c.numel())) - 1)]
            rows[f"{name}, {label}, back to back"] = [cs.time_stream_ms(call, sets, calls=len(sets) * max(1, 12 // len(sets)))]
            del sets
        for name, label, _, _, err in order:
            flushed = rows[f"{name}, {label}, after a flush"]
            print(f"[bert] {label}, {name}: {' / '.join(f'{t:.4f}' for t in flushed)} ms after an L2 flush (two "
                  f"turns), {rows[f'{name}, {label}, back to back'][0]:.4f} ms back to back; max abs err {err:.3g}",
                  flush=True)
    print(f"[bert] SM clock, now and at most: {cs.sm_clocks()}", flush=True)
    return rows


CONFMAT_PARENT = "7e0446e"  # the kernel before the redesign
_CM_COUNT = ("      const int cell = pair_cell(static_cast<long long>(target[r]), arg, a.n_classes, a.cells, a.has_ignore, "
             "a.ignore);\n      if (cell >= 0) atomicAdd(hist + cell, 1);")
_CM_ATOMIC = "      if (cell >= 0) atomicAdd(hist + cell, 1);"
_CM_ROW = "    float best = neg_inf();\n    int arg = INT_MAX;\n    scan_row("
_CM_TARGET = "    const long long t = static_cast<long long>(target[r]);  // every lane, before the scores\n"
_CM_EARLY = [(_CM_ROW, _CM_TARGET + _CM_ROW),
             (_CM_COUNT, _CM_COUNT.replace("pair_cell(static_cast<long long>(target[r]),", "pair_cell(t,"))]
_CM_MERGE = "#pragma unroll\n    for (int offset = 16; offset > 0; offset >>= 1) {"
_CM_ROW_PREFETCH = """    if ((threadIdx.x & 31) == 0 && !a.shared && t >= 0 && t < a.n_classes) {  // the state row t, to L2
      const uintptr_t lo = reinterpret_cast<uintptr_t>(a.state + t * a.n_classes) & ~static_cast<uintptr_t>(15);
      const uintptr_t hi = (reinterpret_cast<uintptr_t>(a.state + (t + 1) * a.n_classes) + 15) & ~static_cast<uintptr_t>(15);
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" :: "l"(lo), "r"(static_cast<unsigned>(hi - lo)));
    }
"""
_CM_CELL_PREFETCH = """    if (!a.shared && t >= 0 && t < a.n_classes && arg < a.n_classes) {  // this lane's candidate cell, to L2
      asm volatile("prefetch.global.L2 [%0];" :: "l"(a.state + t * a.n_classes + arg));
    }
"""
_CM_SCAN = "    scan_row(preds + static_cast<long long>(r) * a.n_scores, a.n_scores, a.vec, best, arg);\n"
_CM_TMA_HELPER = r"""constexpr int kTmaBytes = 4096;  // a warp's row buffer: rows of up to 1,024 float32 scores

__device__ __forceinline__ unsigned smem_u32(const void* p) { return static_cast<unsigned>(__cvta_generic_to_shared(p)); }

// The row by one bulk copy (TMA) into the warp's buffer, completing on its mbarrier, then scanned from there.
template <typename T>
__device__ __forceinline__ void scan_row_tma(const T* row, int n_scores, float& best, int& arg, unsigned& uses) {
  __shared__ alignas(128) float4 rows[kRowThreads / 32][kTmaBytes / 16];
  __shared__ alignas(8) unsigned long long bars[kRowThreads / 32];
  const int w = threadIdx.x / 32, lane = threadIdx.x & 31;
  const unsigned bar = smem_u32(&bars[w]);
  if (lane == 0) {
    if (uses == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    const unsigned bytes = static_cast<unsigned>(n_scores) * sizeof(T);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(bar), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 :: "r"(smem_u32(rows[w])), "l"(row), "r"(bytes), "r"(bar) : "memory");
  }
  __syncwarp();
  unsigned done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(uses & 1) : "memory");
  }
  ++uses;
  constexpr int kV = 16 / sizeof(T);
  for (int j = lane; j < n_scores / kV; j += 32) {
    const float4 raw = rows[w][j];
    const T* chunk = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int q = 0; q < kV; ++q) take(widen(chunk[q]), j * kV + q, best, arg);
  }
  __syncwarp();  // the buffer read by every lane before lane 0 refills it
}

// A warp a row of scores (inner == 1).
"""
_CM_TMA = [("// A warp a row of scores (inner == 1).\n", _CM_TMA_HELPER),
           ("  const int stride = gridDim.x * warps;\n", "  const int stride = gridDim.x * warps;\n  unsigned uses = 0;\n"),
           (_CM_SCAN, "    if (a.vec && a.n_scores * static_cast<int>(sizeof(T)) <= kTmaBytes) {\n"
                      "      scan_row_tma(preds + static_cast<long long>(r) * a.n_scores, a.n_scores, best, arg, uses);\n"
                      "    } else {\n  " + _CM_SCAN + "    }\n")]
_CM_LOAD = "        if (j0 + 32 * u < n_vec) raw[u] = v16[j0 + 32 * u];\n"
_CM_LOAD_256 = """        if (j0 + 32 * u < n_vec) {
          asm volatile("ld.global.nc.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
                       : "=f"(raw[u].x), "=f"(raw[u].y), "=f"(raw[u].z), "=f"(raw[u].w) : "l"(v16 + j0 + 32 * u));
        }
"""
_CM_MERGE_RULE = "  const bool merge = !LABELS || a.shared;\n"
_CM_STATE_PREFETCH = """  if (!a.shared && threadIdx.x == 0) {  // this block's share of the state, to L2, while the labels load
    const long long bytes = 4LL * a.cells, share = ((bytes + gridDim.x - 1) / gridDim.x + 15) / 16 * 16;
    const long long lo = share * blockIdx.x;
    if (lo < bytes) {
      const unsigned size = static_cast<unsigned>((min(share, bytes - lo) + 15) / 16 * 16);
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" :: "l"(reinterpret_cast<uintptr_t>(a.state) + lo),
                   "r"(size));
    }
  }
"""
CONFMAT_VARIANTS = {  # name: (edits of csrc/confmat.cu, checked against the plain version, cases timed)
    "shipped": ([], True, "abcd"),
    "rows: targets read early (every lane, before the scores)": (_CM_EARLY, True, "a"),
    "rows: targets read early, the cell stored, no atomic (timing only)": (
        _CM_EARLY + [(_CM_ATOMIC, "      hist[r] = cell;")], False, "a"),
    "rows: the cell stored, no atomic (timing only)": ([(_CM_ATOMIC, "      hist[r] = cell;")], False, "a"),
    "rows: the argmax stored, no target read, no atomic (timing only)": ([(_CM_COUNT, "      hist[r] = arg;")],
                                                                          False, "a"),
    "rows: the state row prefetched to L2 once the target is in": (
        _CM_EARLY + [(_CM_TARGET, _CM_TARGET + _CM_ROW_PREFETCH)], True, "a"),
    "rows: each lane's candidate cell prefetched before the merge": (
        _CM_EARLY + [(_CM_MERGE, _CM_CELL_PREFETCH + _CM_MERGE)], True, "a"),
    "rows: the row by a TMA bulk copy into shared memory": (_CM_TMA, True, "a"),
    "rows: 16-byte loads with a 256-byte L2 fetch": ([(_CM_LOAD, _CM_LOAD_256)], True, "a"),
    "rows: no loads, a store a row (timing only)": ([(_CM_SCAN, "    arg = r % a.n_scores;\n"),
                                                     (_CM_COUNT, "      hist[r] = arg;")], False, "a"),
    "labels: the loads alone, no atomics (timing only)": ([(
        "  } else if (cell >= 0) {\n    atomicAdd(hist + cell, 1);",
        "  } else if (cell >= 0 && cell == blockDim.x * gridDim.x) {  // almost never\n    hist[0] = 1;")],
        False, "cd"),
    "labels: the state prefetched to L2 at launch": ([(_CM_MERGE_RULE, _CM_MERGE_RULE + _CM_STATE_PREFETCH)],
                                                     True, "cd"),
    "labels: lanes merged (__match_any_sync) on every path": ([(_CM_MERGE_RULE, "  const bool merge = true;\n")],
                                                               True, "cd"),
}
CONFMAT_CALLS = {  # name: (a build of CONFMAT_VARIANTS, the cases, what the call changes from the plan's)
    "labels: blocks of 64 threads": ("shipped", "cd", {"threads": 64}),
    "labels: blocks of 128 threads": ("shipped", "cd", {"threads": 128}),
    "labels (c): the shared histogram": ("shipped", "c", {"shared": True}),
    "rows: blocks of 64 threads": ("shipped", "a", {"threads": 64}),
}
_SASS_KINDS = ("LDG", "SHFL", "RED", "ATOM", "ATOMG", "STG", "CCTL", "UBLKPF", "UBLKCP", "SYNCS", "LDS", "MATCH")


def _sass_order(lib_path: str, kernel: str) -> str:
    """The memory, shuffle and atomic instructions of ``kernel`` (a mangled-name fragment) in program order, runs of
    one kind counted: where a load issues against the shuffles and the atomic."""
    sass = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass", lib_path],
                          capture_output=True, text=True, check=True).stdout
    block = next((b for b in sass.split("Function : ")[1:] if kernel in b.split()[0]), "")
    ops = [op for op in (re.sub(r"^@!?U?P\w+\s+", "", m.group(1)).split()[0] for m in
                         (re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line) for line in block.splitlines()) if m)
           if op.split(".")[0] in _SASS_KINDS]
    runs = []
    for op in ops:
        if runs and runs[-1][0] == op:
            runs[-1][1] += 1
        else:
            runs.append([op, 1])
    return " ".join(op if n == 1 else f"{op} x{n}" for op, n in runs)


def _confmat(flush: torch.Tensor, parent) -> dict:
    """Every build of ``CONFMAT_VARIANTS`` and call of ``CONFMAT_CALLS`` at its cases of phase 3's (a)-(d) and,
    with ``parent``, the parent's kernel with its own plan at all four; each checked build held equal to the plain version
    (``torch.equal``) at its cases; timed after a flush in two turns (parent, new, new, parent) and back to back;
    the rows kernel's load, shuffle and atomic order from ``cuobjdump -sass`` for each rows build."""
    from torchmetrics_tpu_torch.kernels import confmat as kcm

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 4)
    cases = {"a": (*cs._confmat_case(cs.BATCH, cs.N_CLASSES, (), gen), cs.N_CLASSES, None),
             "b": (*cs._seg_batch(gen), cs.SEG_SHAPE[1], cs.SEG_IGNORE),
             "c": (*cs._nominal_kernel_labels(gen), None), "d": (*cs._clustering_kernel_labels(gen), None)}
    names = {"a": "(a) ImageNet-1k batch", "b": "(b) Cityscapes batch", "c": "(c) nominal, 1,024 labels at C = 42",
             "d": "(d) clustering, 50,000 labels at C = 1,000"}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    with tempfile.TemporaryDirectory() as workdir:
        builds = _edited_builds("confmat", {k: (v[0], []) for k, v in CONFMAT_VARIANTS.items()}, workdir,
                                skip_failed=True)
        libs = {name: (lib, report, kcm.plan) for name, (lib, report) in builds.items()}
        paths = {name: os.path.join(workdir, f"libconfmat{i}.so") for i, name in enumerate(CONFMAT_VARIANTS)}
        if parent:
            old = os.path.join(workdir, "parent", "confmat.cu")
            os.makedirs(os.path.dirname(old))
            shutil.copy(os.path.join(parent, "torchmetrics_tpu_torch", "csrc", "confmat.cu"), old)
            proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", old[:-3] + ".so", old],
                                  capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"kernel_ablation: nvcc failed for the parent:\n{proc.stdout}{proc.stderr}")
            spec = importlib.util.spec_from_file_location(
                "parent_confmat", os.path.join(parent, "torchmetrics_tpu_torch", "kernels", "confmat.py"))
            parent_module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(parent_module)
            report = " ".join(l.strip() for l in (proc.stdout + proc.stderr).splitlines() if "registers" in l)
            name = f"parent ({CONFMAT_PARENT})"
            libs[name] = (ctypes.CDLL(old[:-3] + ".so"), report, parent_module.plan)
            paths[name] = old[:-3] + ".so"
        for name, path in paths.items():
            if name in libs and (name.startswith("parent") or name.startswith("rows") or name == "shipped"):
                print(f"[confmat] {name}: confmat_rows_kernel<float, int64> SASS order: "
                      f"{_sass_order(path, 'confmat_rows_kernelIfx')}", flush=True)
        runs = []  # (name, case, call)
        variants = {f"parent ({CONFMAT_PARENT})": ("abcd", True, {})} if parent else {}
        variants.update({name: (v[2], v[1], {}) for name, v in CONFMAT_VARIANTS.items()})
        variants.update({name: (c, True, over) for name, (build, c, over) in CONFMAT_CALLS.items()})
        for name, (timed_at, checked, over) in variants.items():
            if (CONFMAT_CALLS[name][0] if name in CONFMAT_CALLS else name) not in libs:
                continue  # its build failed (reported above)
            lib, report, plan_of = libs[CONFMAT_CALLS[name][0] if name in CONFMAT_CALLS else name]
            if name not in CONFMAT_CALLS:
                print(f"[confmat] build {name!r}: {report}", flush=True)
            fn = lib.confmat_multiclass_launch
            fn.argtypes = kcm.ARGTYPES
            fn.restype = ctypes.c_int
            for case in timed_at:
                preds, target, c, ignore = cases[case]
                n, k, inner = kcm._layout(torch.empty((c, c)), preds, target)
                g = plan_of(n * inner, k, inner, c, not preds.is_floating_point(), sms)
                threads = over.get("threads", g.threads)
                if g.mode == "labels":
                    blocks = max(1, min(_build.cdiv(n * inner, threads), kcm.ELEMENT_BLOCKS_PER_SM * sms))
                else:  # a warp a row, as many rows a block as warps
                    blocks = g.blocks if threads == g.threads else _build.cdiv(n, threads // 32)
                shared = over.get("shared", g.shared)

                def call(state, fn=fn, preds=preds, target=target, c=c, ignore=ignore, g=g, n=n, k=k, inner=inner,
                         blocks=blocks, threads=threads, shared=shared):
                    err = fn(preds.data_ptr(), kcm.PRED_KINDS[preds.dtype], target.data_ptr(),
                             kcm.TARGET_KINDS[target.dtype], state.data_ptr(), n, k, inner, c,
                             int(ignore is not None), int(ignore or 0), kcm.MODES[g.mode], int(shared), blocks,
                             threads, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"kernel_ablation: confmat launch failed with CUDA error {err}")
                    return state

                state = torch.randint(-(2**20), 2**20, (c, c), generator=gen, device="cuda", dtype=torch.int32)
                got = call(state.clone())
                want = kcm._confmat_multiclass_plain(state.clone(), preds, target, ignore)
                torch.cuda.synchronize()
                if checked:
                    cs.check(torch.equal(got, want), f"[confmat] {name}, {names[case]}: differs from plain")
                runs.append((name, case, call, state, (g.mode, shared, blocks, threads)))
        order = sorted(runs, key=lambda r: not r[0].startswith("parent"))
        for turn in (order, order[::-1]):
            for name, case, call, state, _ in turn:
                rows.setdefault(f"{name}, {names[case]}, after a flush", []).append(cs.time_ms(lambda: call(state), flush))
        for name, case, call, state, _ in order:
            preds, target, _, _ = cases[case]
            nbytes = preds.numel() * preds.element_size() + target.numel() * target.element_size()
            copies = min(cs.copies_for(nbytes), cs.MAX_STREAM_COPIES)
            sets = [(state, preds, target)] + [(state, preds.clone(), target.clone()) for _ in range(copies - 1)]
            rows[f"{name}, {names[case]}, back to back"] = [cs.time_stream_ms(
                lambda s, p, t, call=call: call(s, preds=p, target=t), sets, calls=len(sets) * max(1, 48 // len(sets)))]
            del sets
        for name, case, _, _, geometry in order:
            flushed = rows[f"{name}, {names[case]}, after a flush"]
            print(f"[confmat] {names[case]}, {name}: {' / '.join(f'{t:.4f}' for t in flushed)} ms after an L2 flush "
                  f"(two turns), {rows[f'{name}, {names[case]}, back to back'][0]:.4f} ms back to back; "
                  f"(mode, shared, blocks, threads) {geometry}", flush=True)
    print(f"[confmat] SM clock, now and at most: {cs.sm_clocks()}", flush=True)
    return rows


POLY_PARENT = "4c65b25"  # the kernel before the redesign: 8 x 8 float32 FMA sums a thread, 128 x 128 tiles
_PM_PROMOTE = "constexpr int kPromote = 2;"
_PM_PRODUCTS = """          Wgmma<kCols>::run(acc, a[1][ks], bh);
          Wgmma<kCols>::run(acc, a[0][ks], bl);
          Wgmma<kCols>::run(acc, a[0][ks], bh);"""
_PM_SPLIT_B = ("""      split(v[i].x, h.x, l.x);
      split(v[i].y, h.y, l.y);
      split(v[i].z, h.z, l.z);
      split(v[i].w, h.w, l.w);""", """      h = *reinterpret_cast<const uint4*>(&v[i]);
      l = h;""")
_PM_SPLIT_A = ("        for (int e = 0; e < 4; ++e) split(v[ks][e], a[0][ks][e], a[1][ks][e]);",
               "        for (int e = 0; e < 4; ++e) a[0][ks][e] = a[1][ks][e] = __float_as_uint(v[ks][e]);")
_PM_LOADS_B = ("      v[i] = load4(col[i] + k, n, t.vec);", "      v[i] = make_float4(t.d, k, n, q);")
_PM_LOADS_A = ("        const float2 x = load2(row[r], k, t.d, t.vec);", "        const float2 x = make_float2(k, r);")
_PM_NO_REDO = ("        if (!isfinite(dot)) {", "        if (false) {")  # no second take
_PM_NEVER = ("      if ((c + 1) % kPromote == 0) {", "      if (false) {")  # the accumulators never promoted


def _pm(promote: int = 2, stages: int = 4) -> list:
    """The edits that set the promotion period (at least 1) and the ring's slots."""
    edits = [(_PM_PROMOTE, f"constexpr int kPromote = {promote};")] if promote != 2 else []
    return edits + ([("constexpr int kStages = 4;", f"constexpr int kStages = {stages};")] if stages != 4 else [])


POLY_VARIANTS = {  # name: (edits of csrc/poly_mmd.cu, checked against the plain version)
    "shipped": ([], True),
    "promoted every chunk": (_pm(promote=1), True),
    "never promoted": ([_PM_NEVER], True),
    "three slots": (_pm(stages=3), True),
    "four-byte loads of the rows in the features' order": ([
        ("      const int p0 = staged(column(i), pair_at(q)), p1 = staged(column(i), pair_at(q) + 4);\n"
         "      *reinterpret_cast<uint2*>(hi + p0) = make_uint2(h.x, h.z);\n"
         "      *reinterpret_cast<uint2*>(hi + p1) = make_uint2(h.y, h.w);\n"
         "      *reinterpret_cast<uint2*>(hi + kSlotHalf + p0) = make_uint2(l.x, l.z);\n"
         "      *reinterpret_cast<uint2*>(hi + kSlotHalf + p1) = make_uint2(l.y, l.w);",
         "      const int at = staged(column(i), 4 * q);\n"
         "      *reinterpret_cast<uint4*>(hi + at) = h;\n"
         "      *reinterpret_cast<uint4*>(hi + kSlotHalf + at) = l;"),
        ("        const float2 x = load2(row[r], k, t.d, t.vec);\n        v[ks][r] = x.x;\n        v[ks][r + 2] = x.y;",
         "        const int kq = c * kChunk + 8 * ks + q;\n"
         "        v[ks][r] = load2(row[r], kq, kq + 1, 0).x;\n"
         "        v[ks][r + 2] = load2(row[r], kq + 4, kq + 5, 0).x;")], True),
    "one producer warpgroup": ([("constexpr int kProducers = 256;", "constexpr int kProducers = 128;"),
                                ("constexpr int kConsumerRegs = 192, kProducerRegs = 64;",  # within 384 x 168
                                 "constexpr int kConsumerRegs = 192, kProducerRegs = 120;")], True),
    "consumers 200 registers, producers 56": ([("constexpr int kConsumerRegs = 192, kProducerRegs = 64;",
                                                "constexpr int kConsumerRegs = 200, kProducerRegs = 56;")], True),
    "the split by cvt.rna.tf32.f32": ([(
        "  hi = x != x ? 0x7fffffffu : (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
        "  const uint32_t rest = __float_as_uint(x - __uint_as_float(hi));\n"
        "  lo = (hi & 0x7f800000u) == 0x7f800000u ? 0u : (rest + 0x1000u) & 0xffffe000u;",
        '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(x));\n'
        '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));\n'
        '  lo = (hi & 0x7f800000u) == 0x7f800000u ? 0u : lo;')], True),
    "one TF32 pass (timing only)": ([(_PM_PRODUCTS, "          Wgmma<kCols>::run(acc, a[0][ks], bh);")], False),
    "no split (timing only)": ([_PM_SPLIT_A, _PM_SPLIT_B, _PM_NO_REDO], False),
    "no loads (timing only)": ([_PM_LOADS_A, _PM_LOADS_B, _PM_NO_REDO], False),
    "no loads of the rows (timing only)": ([_PM_LOADS_A, _PM_NO_REDO], False),
    "no loads of the columns (timing only)": ([_PM_LOADS_B, _PM_NO_REDO], False),
    "products alone (timing only)": ([_PM_LOADS_A, _PM_LOADS_B, _PM_SPLIT_A, _PM_SPLIT_B, _PM_NO_REDO], False),
    "products alone, never promoted (timing only)": (
        [_PM_LOADS_A, _PM_LOADS_B, _PM_SPLIT_A, _PM_SPLIT_B, _PM_NO_REDO, _PM_NEVER], False),
}
POLY_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def _poly(flush: torch.Tensor, parent) -> dict:
    """Every variant of ``poly_mmd`` and, with ``parent`` (a checkout of ``4c65b25``), the kernel before the
    redesign at phase 3's case (a), KID's defaults (timed after a flush in two turns, parent, new, new, parent), and
    case (f), the same with 8 outlier dimensions: each build's ptxas report, its error against the plain version and
    against a float64 evaluation at both. Then the shipped build at (a) with a +inf feature in 1 % of the real rows
    and in all of them (the non-finite products taken again), timed after a flush, its NaN held to plain's."""
    from torchmetrics_tpu_torch.kernels import poly_mmd as kpm
    from torchmetrics_tpu_torch.utilities.precision import full_float32

    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 62)
    n, d, subsets, m = 10_000, 2048, 100, 1000
    x, y = cs._kid_features(gen, n, d), cs._kid_features(gen, n, d, shift=0.05)
    ix, iy = cs._kid_subsets(gen, n, n, subsets, m)
    xo, yo = x.clone(), y.clone()
    xo[:, :cs.KID_OUTLIERS] *= cs.KID_OUTLIER_SCALE
    yo[:, :cs.KID_OUTLIERS] *= cs.KID_OUTLIER_SCALE
    cases = {"(a)": (x, y), "(f)": (xo, yo)}
    g = 1.0 / d
    with full_float32():
        plain = {label: kpm._poly_mmd_plain(a, b, ix, iy, 3, g, 1.0).double() for label, (a, b) in cases.items()}
    exact = {label: cs._kid_float64(a, b, ix, iy, 3, g, 1.0) for label, (a, b) in cases.items()}
    out = torch.empty(subsets, device="cuda")
    sums = torch.zeros(3 * subsets, dtype=torch.float64, device="cuda")
    tickets = torch.zeros(subsets, dtype=torch.int32, device="cuda")
    with tempfile.TemporaryDirectory() as workdir:
        builds = _edited_builds("poly_mmd", {k: (v[0], []) for k, v in POLY_VARIANTS.items()}, workdir)
        entries = {name: (lib, report, POLY_VARIANTS[name][1]) for name, (lib, report) in builds.items()}
        if parent:
            old = os.path.join(workdir, "parent", "poly_mmd.cu")
            os.makedirs(os.path.dirname(old))
            shutil.copy(os.path.join(parent, "torchmetrics_tpu_torch", "csrc", "poly_mmd.cu"), old)
            proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", old[:-3] + ".so", old],
                                  capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"kernel_ablation: nvcc failed for the parent:\n{proc.stdout}{proc.stderr}")
            report = " ".join(l.strip() for l in (proc.stdout + proc.stderr).splitlines()
                              if "spill" in l or "registers" in l)
            entries[f"parent ({POLY_PARENT})"] = (ctypes.CDLL(old[:-3] + ".so"), report, True)
        runs = []
        for name, (lib, report, checked) in entries.items():
            print(f"[poly_mmd] build {name!r}: {report}", flush=True)
            fn = lib.poly_mmd_launch
            fn.argtypes = POLY_ARGTYPES
            fn.restype = ctypes.c_int

            def call(a, b, fn=fn):
                err = fn(a.data_ptr(), b.data_ptr(), ix.data_ptr(), iy.data_ptr(), out.data_ptr(), sums.data_ptr(),
                         tickets.data_ptr(), subsets, m, d, 3, g, 1.0, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"kernel_ablation: poly_mmd launch failed with CUDA error {err}")
                return out

            for label, (a, b) in cases.items():
                got = call(a, b).double()
                torch.cuda.synchronize()
                mmd, scale = exact[label]
                err = float(((got - plain[label]).abs() / scale).max())
                f64 = float(((got - mmd).abs() / scale).max())
                rows[f"{name}, {label}, err over scale against plain / float64"] = [err, f64]
                print(f"[poly_mmd] {name}, {label}: max err over scale {err:.3g} against plain, {f64:.3g} against "
                      f"float64 (plain's {float(((plain[label] - mmd).abs() / scale).max()):.3g})", flush=True)
                if checked:
                    cs.check(err <= cs.KID_TOL, f"[poly_mmd] {name}, {label}: {err:.3g} of scale from plain")
            runs.append((name, call, cases["(a)"]))
        order = sorted(runs, key=lambda r: not r[0].startswith("parent"))  # the parent first: parent, new, new, parent
        for turn in (order, order[::-1]):
            for name, call, args in turn:
                rows.setdefault(f"{name}, (a), after a flush", []).append(
                    cs.time_ms(lambda: call(*args), flush, reps=10))
        bound = cs._poly_mmd_bounds(subsets, m, d)
        for name, _, _ in order:
            flushed = rows[f"{name}, (a), after a flush"]
            print(f"[poly_mmd] (a), {name}: {' / '.join(f'{t:.4f}' for t in flushed)} ms after an L2 flush (two "
                  f"turns); three TF32 passes' bound {bound['tf32_bound_ms']:.4f} ms "
                  f"({bound['tf32_bound_ms'] / min(flushed):.1%}), float32's {bound['fp32_bound_ms']:.4f} ms "
                  f"({bound['fp32_bound_ms'] / min(flushed):.1%})", flush=True)
        shipped = {name: call for name, call, _ in runs}["shipped"]
        for label, every in (("1 % of the real rows", 100), ("every real row", 1)):
            xi = x.clone()
            xi[::every, 3] = float("inf")
            with full_float32():
                want = kpm._poly_mmd_plain(xi, y, ix, iy, 3, g, 1.0)
            got = shipped(xi, y).clone()
            torch.cuda.synchronize()
            cs.check(torch.equal(got.isnan(), want.isnan()) and torch.equal(got.isinf(), want.isinf()),
                     f"[poly_mmd] shipped, a +inf feature in {label}: NaN or inf differ from plain")
            flushed = rows[f"shipped, (a), a +inf feature in {label}, after a flush"] = [
                cs.time_ms(lambda: shipped(xi, y), flush, reps=5)]
            print(f"[poly_mmd] (a), shipped, a +inf feature in {label} ({int(want.isnan().sum())} of {subsets} "
                  f"subsets NaN, as plain): {flushed[0]:.4f} ms after an L2 flush", flush=True)
    print(f"[poly_mmd] SM clock, now and at most: {cs.sm_clocks()}", flush=True)
    return rows


_QH_UNROLL = "constexpr int kUnroll = 8;  // entries a thread loads before it counts any"
QH_VARIANTS = {  # name: the source text replaced in csrc/quantile_hist.cu; "shipped" first
    "shipped (kUnroll 8)": [],
    **{f"kUnroll {u}": [(_QH_UNROLL, _QH_UNROLL.replace("= 8;", f"= {u};"))] for u in (1, 2, 4, 16)},
}
QH_CASES = (("(a) ImageNet-1k batch", cs.BATCH, cs.N_CLASSES, "multiclass"),
            ("(b) MS-COCO batch", cs.COCO_ML_BATCH, cs.COCO_ML_LABELS, "multilabel"),
            ("(c) binary batch", cs.BATCH, 1, "binary"),
            ("the MS-COCO set in one launch", cs.COCO_ML_IMAGES, cs.COCO_ML_LABELS, "multilabel"))


def _quantile_hist(flush: torch.Tensor, gen: torch.Generator) -> dict:
    """Every variant of ``quantile_hist`` (``QH_VARIANTS``) at ``QH_CASES``, through its C entry with the launcher's
    plan, timed after a flush; each state held equal to the plain version's first."""
    from torchmetrics_tpu_torch.kernels import quantile_hist as kqh
    from torchmetrics_tpu_torch.sketches import QuantileSketch

    grid = QuantileSketch(cs.SKETCH_BINS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    with tempfile.TemporaryDirectory() as workdir:
        builds = _edited_builds("quantile_hist", {k: (v, []) for k, v in QH_VARIANTS.items()}, workdir)
        for name, (_, report) in builds.items():
            print(f"[quantile_hist] {name}: {report}", flush=True)
        for label, n, k, task in QH_CASES:
            scores, target, weights, hist = cs._qh_case(gen, n, k, task, grid)
            want = kqh._quantile_hist_plain(hist, scores, target, weights, grid)
            pl = kqh.plan(n, k, grid.bins + 1, sms)
            stream = torch.cuda.current_stream().cuda_stream
            line = {}
            for name, (lib, _) in builds.items():
                fn = lib.quantile_hist_launch
                pp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
                fn.argtypes = [pp, pp, pp, pp, ll, i, i, f, f, i, i, ll, i, i, pp]
                fn.restype = ctypes.c_int

                def call(h, fn=fn):
                    err = fn(scores.data_ptr(), target.data_ptr(), weights.data_ptr(), h.data_ptr(), n, k, grid.bins,
                             float(grid.lo), float(grid.scale), int(task == "multiclass"), pl.slice,
                             pl.rows_per_chunk, pl.chunks, int(pl.shared), stream)
                    cs.check(err == 0, f"quantile_hist {name}: CUDA error {err}")

                got = hist.clone()
                call(got)
                torch.cuda.synchronize()
                cs.check(torch.equal(got, want), f"quantile_hist {name} differs from plain at {label}")
                timed = hist.clone()
                line[name] = cs.time_ms(lambda: call(timed), flush)
            rows[label] = {"plan": pl._asdict(), "ms": line}
            print(f"[quantile_hist] {label} {task} ({n}, {k}), plan {tuple(pl)}: "
                  + ", ".join(f"{name} {ms * 1e3:.2f} us" for name, ms in line.items()), flush=True)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--sections",
                        default="ranking,multilabel,calibration,calibration-widths,retrieval,retrieval-occupancy,"
                                "retrieval-builds,ssim,pairwise,sdr,snr,bert,confmat,poly_mmd,quantile_hist",
                        help="comma-separated sections to run")
    parser.add_argument("--parent", help="a checkout of the commit before the redesign of the sections run "
                                          f"(calibration: {PARENT_COMMIT}; pairwise: {PAIRWISE_PARENT}; sdr, snr: "
                                          f"{SDR_PARENT}; bert: {BERT_PARENT}; confmat: {CONFMAT_PARENT}; poly_mmd: "
                                          f"{POLY_PARENT}), timed beside it")
    parser.add_argument("--sass", help="pairwise: also write the shipped build's SASS to this file")
    parser.add_argument("--fault-builds", default=",".join(RET_FAULT_BUILDS),
                        help="retrieval-fault: comma-separated builds of RET_FAULT_BUILDS to run")
    parser.add_argument("--fault-trials", type=int, default=RET_FAULT_TRIALS, help="retrieval-fault: seeds to run")
    parser.add_argument("--json", help="also write the times to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ablation: CUDA is not available", file=sys.stderr)
        return 1
    device = cs.phase_device()
    flush = cs.flush_buffer()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 13)
    sections = args.sections.split(",")
    record = {"device": device}
    if "ranking" in sections:
        record["ranking"] = _ranking(flush, gen)
    if "multilabel" in sections:
        record["multilabel"] = _multilabel(flush, gen)
    if "calibration" in sections:
        record["calibration"] = _calibration(flush, gen, args.parent)
    if "calibration-widths" in sections:
        record["calibration-widths"] = _calibration_widths(flush, gen)
    if "retrieval" in sections:
        record["retrieval"] = _retrieval(flush, gen)
    if "retrieval-builds" in sections:
        record["retrieval-builds"] = _retrieval_builds(flush, gen)
    if "retrieval-occupancy" in sections:
        record["retrieval-occupancy"] = _retrieval_occupancy(flush, gen)
    if "retrieval-fault" in sections:
        record["retrieval-fault"] = _retrieval_fault(args.fault_builds.split(","), args.fault_trials)
    if "ssim" in sections:
        record["ssim"] = _ssim(flush, gen)
    if "pairwise" in sections:
        record["pairwise"] = _pairwise(flush, gen, args.parent, args.sass)
    if "sdr" in sections:
        record["sdr"] = _sdr(flush, gen, args.parent)
    if "snr" in sections:
        record["snr"] = _snr(flush, gen, args.parent)
    if "bert" in sections:
        record["bert"] = _bert(flush, args.parent)
    if "confmat" in sections:
        record["confmat"] = _confmat(flush, args.parent)
    if "poly_mmd" in sections:
        record["poly_mmd"] = _poly(flush, args.parent)
    if "quantile_hist" in sections:
        record["quantile_hist"] = _quantile_hist(flush, gen)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
