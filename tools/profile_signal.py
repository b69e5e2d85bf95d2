#!/usr/bin/env python3
"""Where phase 10's two heaviest legs spend their time, by operation, on one GPU.

    python3 tools/profile_signal.py [--repo CHECKOUT] [--json PATH]

Runs ``chip_smoke.py``'s phase 10 (i) (MS MARCO's dev (small) shape: ten
retrieval metrics over 6,980 queries of 1,000 candidates in updates of 100
queries, one compute group) and (iii) (PSNR, SSIM, MS-SSIM and VIF over a
DIV2K batch of 4 images of 3 x 1356 x 2040) from the checkout ``--repo``
(this one by default, or a ``git archive`` of an earlier commit), with that
checkout's own data generators and metrics. It times the collection's
compute of (i) and one update of (iii) by host clock after a synchronize
(median of 5, after 2 warm-up runs), then traces one more of each with
``torch.profiler`` (CPU and CUDA activity) and prints the operations that
take the most device time and host time, each with its calls. The device
time is CUPTI's kernel time; a leg's idle share is one minus its summed
kernel time over its host-clock time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _ops(prof, n: int = 14) -> dict:
    from torch.autograd import DeviceType

    rows, kernels = [], 0.0
    for e in prof.key_averages():
        device_us = getattr(e, "self_device_time_total", None)
        if device_us is None:
            device_us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append({"name": e.key, "calls": e.count, "device_ms": device_us / 1e3,
                     "host_ms": e.self_cpu_time_total / 1e3})
        if getattr(e, "device_type", None) == DeviceType.CUDA:  # the kernels themselves, not the ops above them
            kernels += device_us / 1e3
    by_device = sorted(rows, key=lambda r: -r["device_ms"])[:n]
    by_host = sorted(rows, key=lambda r: -r["host_ms"])[:n]
    return {"device_ms_total": kernels, "by_device": by_device, "by_host": by_host}


def _fresh(col):
    """The collection's compute, its members' cached values dropped first."""
    for _, metric in col.items(keep_base=True):
        metric._computed = None
    return col.compute()


def _timed(fn, reps: int = 5) -> float:
    import torch

    times = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[2:])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        help="the checkout whose port and chip_smoke.py to run")
    parser.add_argument("--json", help="also write the record to this file")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_signal: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs

    name_limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                capture_output=True, text=True).stdout.strip()
    record = {"repo": os.path.abspath(args.repo), "device": name_limit, "torch": torch.__version__}
    device = torch.device("cuda")

    # (i): the collection's compute after every update of MS MARCO's shape
    col = cs._retrieval_msmarco(device, True)
    batches = cs._msmarco_batches(cs.SEED + 20, cs.MSMARCO_QUERIES, cs.MSMARCO_UPDATE_QUERIES,
                                  cs.MSMARCO_CANDIDATES, cs.MSMARCO_RELEVANT)
    for batch, kwargs in batches():
        col.update(*batch, **kwargs)
    torch.cuda.synchronize()
    host_ms = _timed(lambda: _fresh(col))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _fresh(col)
        torch.cuda.synchronize()
    ops = _ops(prof)
    record["msmarco_compute"] = {"host_ms": host_ms, **ops, "idle_share": 1 - ops["device_ms_total"] / host_ms}
    del col

    # (iii): one update of the DIV2K collection on a batch of 4
    col = cs._signal_div2k(device, True)
    (preds, target), _ = next(iter(cs._image_batches(cs.SEED + 22, cs.DIV2K_BATCH, cs.DIV2K_BATCH,
                                                     cs.DIV2K_SHAPE[1:], 0.05)()))
    host_ms = _timed(lambda: col.update(preds, target))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        col.update(preds, target)
        torch.cuda.synchronize()
    ops = _ops(prof)
    record["div2k_update"] = {"host_ms": host_ms, **ops, "idle_share": 1 - ops["device_ms_total"] / host_ms}

    print(f"[profile] {name_limit}; torch {torch.__version__}; checkout {record['repo']}")
    for leg in ("msmarco_compute", "div2k_update"):
        r = record[leg]
        print(f"[profile] {leg}: {r['host_ms']:.4f} ms by host clock, {r['device_ms_total']:.4f} ms of device "
              f"time traced, idle share {r['idle_share']:.3f}")
        for kind in ("by_device", "by_host"):
            for row in r[kind]:
                print(f"[profile]   {kind[3:]}: {row['name'][:90]}: {row['calls']} calls, device "
                      f"{row['device_ms']:.4f} ms, host {row['host_ms']:.4f} ms")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
