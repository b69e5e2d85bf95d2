#!/usr/bin/env python3
"""Row chunks of the ``binned_confmat_multilabel`` launch, compared on one GPU.

    python3 tools/binned_multilabel_ab.py [--json PATH]

At the two shapes the curve metrics give the kernel (a COCO-shaped batch,
256 x 80 at 100 thresholds, and a binary batch, 1,024 x 1 at 200), times three
ways of cutting the rows into blocks, in turns (floor, one wave, whole rounds,
whole rounds, one wave, floor): ``floor`` (the chunk's rows rounded down, the
multiclass kernel's rule), ``one wave`` (rounded up: at most two blocks an SM)
and ``whole rounds`` (at least one round of a block's rows). Each form must
equal the plain version; times are ``chip_smoke.py``'s ``time_ms`` (one call
after an L2 flush) and ``time_stream_ms`` (back to back).
"""

import argparse
import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from torchmetrics_tpu_torch.kernels import binned_confmat as kbc  # noqa: E402

FORMS = ("floor", "one wave", "whole rounds", "whole rounds", "one wave", "floor")


def _variant(real_plan, form):
    def plan(n, c, t, sms, one_wave=False):
        g = real_plan(n, c, t, sms, one_wave=form == "one wave")
        rows = g.rows_per_block
        if form == "whole rounds":
            rows = max(rows, kbc.THREADS // (g.tile_c // 4) * 4)
        return g._replace(rows_per_block=rows, grid=(g.grid[0], -(-max(n, 1) // rows), g.grid[2]))
    return plan


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--json", help="also write the rows to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("binned_multilabel_ab: CUDA is not available", file=sys.stderr)
        return 1
    prc = importlib.import_module("torchmetrics_tpu_torch.functional.classification.precision_recall_curve")
    cs.phase_device()
    cs.phase_build()
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 7)
    real_plan, rows = kbc.plan, []
    try:
        for what, n, labels, t in (("(a) COCO", 256, 80, 100), ("(b) one label", 1024, 1, 200)):
            p, tg, w, thr, state = cs._multilabel_inputs(n, labels, t, 0.0, (), gen)
            sthr, order = prc._sort_thresholds(thr)
            want = prc._binned_confmat_multilabel_accumulate_plain(state, p, tg, w, thr)
            for form in FORMS:
                kbc.plan = _variant(real_plan, form)
                fused = lambda s, p_, t_, w_: kbc.binned_confmat_multilabel(s, p_, t_, w_, sthr, order)  # noqa: E731
                cs.check(torch.equal(fused(state, p, tg, w), want), f"{what} {form} differs from the plain version")
                ms = cs.time_ms(lambda: fused(state, p, tg, w), flush)
                sets = [(state, p, tg, w)] + [tuple(x.clone() for x in (state, p, tg, w))
                                              for _ in range(cs.MAX_STREAM_COPIES - 1)]
                stream = cs.time_stream_ms(fused, sets, calls=len(sets))
                grid = kbc.plan(n, labels, t, torch.cuda.get_device_properties(0).multi_processor_count).grid
                print(f"[ab] {what} {form}: {ms:.4f} ms after an L2 flush, {stream:.4f} ms back to back, grid {grid}")
                rows.append({"case": what, "form": form, "ms": ms, "stream_ms": stream, "grid": list(grid)})
    finally:
        kbc.plan = real_plan
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
