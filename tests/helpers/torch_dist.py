"""A ``torch.distributed`` gloo world of CPU processes for the port's sync tests.

A test file that needs several ranks spawns ONE world from a module-scoped
fixture (:func:`run_world`): ``world`` processes each run the test file
itself as a script, which calls :func:`worker_main` with its per-rank check
function. The ranks meet through a file under the test's temporary
directory (``init_method="file://..."``), so files that run side by side
under xdist never share a port. A rank imports torch, numpy and the port
only, never JAX. Each rank writes what its check function returns with
``torch.save``; :func:`run_world` returns the ranks' results in rank order,
and fails with the ranks' output when a rank fails or when the world has
not finished within ``JOIN_TIMEOUT_S`` seconds (a hung collective fails the test
instead of eating the run's time limit).
"""

from __future__ import annotations

import argparse
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List

import torch

REPO = Path(__file__).resolve().parents[2]
JOIN_TIMEOUT_S = 180


def run_world(test_file: str, inputs: Dict[str, Any], tmp_path: Path, world: int) -> List[Any]:
    """Run ``test_file`` as ``world`` gloo ranks on ``inputs``; their results in rank order."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    inputs_path = tmp_path / "inputs.pt"
    torch.save(inputs, inputs_path)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for rank in range(world):
        cmd = [sys.executable, test_file, "--rank", str(rank), "--world", str(world),
               "--init", f"file://{tmp_path / 'rendezvous'}", "--inputs", str(inputs_path),
               "--out", str(tmp_path / f"rank{rank}.pt")]
        log = open(tmp_path / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    failed = []
    try:
        for rank, (proc, _) in enumerate(procs):
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed.append(f"the world did not finish within {JOIN_TIMEOUT_S} s")
                break
            if proc.returncode:
                failed.append(f"rank {rank} exited {proc.returncode}")
    finally:
        for proc, log in procs:  # no rank outlives the test
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        logs = "\n".join(f"--- rank {r}:\n{(tmp_path / f'rank{r}.log').read_text()[-4000:]}" for r in range(world))
        raise AssertionError("; ".join(failed) + "\n" + logs)
    return [torch.load(tmp_path / f"rank{rank}.pt", weights_only=False) for rank in range(world)]


def worker_main(check: Callable[[int, int, Dict[str, Any]], Any]) -> None:
    """The body of one rank: join the gloo world, run ``check(rank, world, inputs)``, save its result."""
    import torch.distributed as dist

    parser = argparse.ArgumentParser()
    for flag in ("--rank", "--world"):
        parser.add_argument(flag, type=int, required=True)
    for flag in ("--init", "--inputs", "--out"):
        parser.add_argument(flag, required=True)
    args = parser.parse_args()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=args.init, rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S - 30))
    try:
        result = check(args.rank, args.world, torch.load(args.inputs, weights_only=False))
        torch.save(result, args.out)
    finally:
        dist.destroy_process_group()
    jax_modules = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "torchmetrics_tpu"))
    if jax_modules:
        raise SystemExit(f"a rank imported {jax_modules[:5]}")
