"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``. Libraries go into the
package's ``_build/`` directory, keyed by a hash of the source and the
flags, so a changed source is rebuilt and an unchanged one is built once.
Nothing is built at import: the first launch builds what it needs, and
:func:`build` compiles several sources at once, one ``nvcc`` each. The
launchers share :func:`cdiv`, :func:`sm_count`, :func:`check_tensor`,
:func:`zero_scratch`, :func:`zero_tickets` and :func:`launch_on`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import torch
from torch import Tensor

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # under CUDA's default install prefix

_loaded: Dict[str, ctypes.CDLL] = {}
_sm_count: Dict[int, int] = {}
_scratch: Dict[Tuple[int, int, str], Tensor] = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc") or DEFAULT_NVCC
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives, keyed by source and flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile the named sources that are not built yet, all at once.

    Returns each compiled source's compiler output (``ptxas`` register and
    spill report); raises ``RuntimeError`` with the output of a failed build.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, target)
    logs = {}
    failed = []
    for name, (proc, tmp, target) in running.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
        else:
            failed.append(f"{name} (exit {proc.returncode}):\n{logs[name]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_count:
        _sm_count[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_count[index]


def check_tensor(kernel: str, name: str, x: Tensor, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    """Raise ``ValueError`` unless ``x`` has the dtype, shape and device a launcher expects and is contiguous."""
    if x.dtype != dtype:
        raise ValueError(f"{kernel}: `{name}` has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{kernel}: `{name}` has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{kernel}: `{name}` must be contiguous")
    if x.device != device:
        raise ValueError(f"{kernel}: `{name}` is on {x.device}, expected {device}")


def zero_scratch(device: torch.device, stream: int, name: str, n_bytes: int) -> Tensor:
    """At least ``n_bytes`` (8-byte aligned) of the stream's scratch ``name``, zero when a launch starts.

    A kernel that merges its blocks through such scratch (tickets, sums) sets
    what it used back to zero in its last block; launches on one stream run in
    order, so the scratch is zeroed once, here, and never again by the host.
    """
    key = (device.index if device.index is not None else torch.cuda.current_device(), stream, name)
    n_words = cdiv(n_bytes, 8)
    if key not in _scratch or _scratch[key].shape[0] < n_words:
        _scratch[key] = torch.zeros((n_words,), dtype=torch.int64, device=device)
    return _scratch[key]


def zero_tickets(device: torch.device, stream: int, n: int) -> Tensor:
    """At least ``n`` int32 tickets of the stream, zero when a launch starts (``zero_scratch``):
    a kernel counts its arriving blocks on one and its last block sets it back to zero."""
    return zero_scratch(device, stream, "tickets", 4 * n).view(torch.int32)


def launch_on(kernel: str, device: torch.device, fn: Callable[..., int], args: tuple) -> None:
    """Call the library's launcher ``fn(*args)`` with ``device`` current; a CUDA error raises ``RuntimeError``."""
    if device.index in (None, torch.cuda.current_device()):
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{kernel}: launch failed with CUDA error {err}")
