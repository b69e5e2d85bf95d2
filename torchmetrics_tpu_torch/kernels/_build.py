"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``. Libraries go into the
package's ``_build/`` directory, keyed by a hash of the source and the
flags, so a changed source is rebuilt and an unchanged one is built once.
Nothing is built at import: the first launch builds what it needs, and
:func:`build` compiles several sources at once, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # under CUDA's default install prefix

_loaded: Dict[str, ctypes.CDLL] = {}


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
