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
4. main path: the single-device eval step (``MulticlassAccuracy`` micro,
   ``MulticlassF1Score`` macro, ``MulticlassAUROC(thresholds=20)``,
   ``MeanSquaredError``) over an ImageNet-1k validation-sized set, 50,000
   samples x 1,000 classes in batches of 1,024, through ``update_state`` and
   ``compute_state``; every kernel of the path must have launched, and the
   first 4 batches rerun on the port's CPU path must give the same states;
   the device operations of one profiled AUROC update are listed with
   their device times.

The line before the last is the kernel record (JSON); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--json", help="also write the full record to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from torchmetrics_tpu_torch.kernels.binned_confmat import binned_confmat_multiclass

    kernels = [binned_confmat_multiclass]
    sources = {"binned_confmat_multiclass": "torchmetrics_tpu_torch/csrc/binned_confmat.cu"}
    replaces = {"binned_confmat_multiclass": "torchmetrics_tpu/functional/classification/precision_recall_curve.py:128"}

    device = phase_device()
    build_s = phase_build()
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")  # 256 MB, past the 50 MB L2
    kernel_rows = phase_kernels(flush)
    del flush
    main = phase_main_path(kernels)

    line = {"kernels": []}
    for kernel in kernels:
        name = kernel.__name__
        slice_row = kernel_rows[name][0]  # the main path's shape
        line["kernels"].append({
            "name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
            "launches": main["launches"][name], "max_abs_err": max(r["max_abs_err"] for r in kernel_rows[name]),
            "ms": slice_row["ms"], "stream_ms": slice_row["stream_ms"], "plain_ms": slice_row["plain_ms"],
            "bound_ms": slice_row["bound_ms"],
            "bound_by": slice_row["bound_by"], "library_ms": None,
        })
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": device, "build_s": build_s, "kernels": kernel_rows, "main_path": main}, f, indent=1)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device["name"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
