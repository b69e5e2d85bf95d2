#!/usr/bin/env python3
"""Where ``ranking_pairs``' sort spends its time, and which label-group width suits
``binned_confmat_multilabel``, on one GPU.

    python3 tools/kernel_ablation.py [--json PATH]

Ranking: ``csrc/ranking.cu`` is copied, ``#if`` switches are put around the
sort and around each kind of its stages (in registers, by warp shuffles,
through shared memory), and the variants are built with the port's ``nvcc``
flags, all at once. Each variant is timed by its C entry, LRAP, at (64, 4096),
(32, 1000) and the COCO batch (256, 80), with 4, 8 and 16 words a thread
where the width allows; a variant without some stages sorts wrongly and is
timed only. Multilabel: the launcher's plan is given 8, 4, 2 and 1 labels a
block at the COCO batch and its last batch (56, 80), in two turns, forward
then backward. Times are ``chip_smoke.time_ms``'s: CUDA events around one
call after a 256 MB L2 flush, medians of 30. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from torchmetrics_tpu_torch.kernels import _build  # noqa: E402
from torchmetrics_tpu_torch.kernels import binned_multilabel as kbm  # noqa: E402
from torchmetrics_tpu_torch.kernels import ranking as krk  # noqa: E402

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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--json", help="also write the times to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ablation: CUDA is not available", file=sys.stderr)
        return 1
    device = cs.phase_device()
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 13)
    record = {"device": device, "ranking": _ranking(flush, gen), "multilabel": _multilabel(flush, gen)}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
