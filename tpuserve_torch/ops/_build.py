"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
into its own shared library, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  Device code shared between kernels lives in
``csrc/*.cuh`` headers.  Libraries land in ``build/tpuserve_torch/`` at the
repository root, named by a hash of the source, the headers and the flags,
so an edited source or header rebuilds and an unchanged one loads the
library already built.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuserve_torch"
KERNELS = ("flash_prefill", "paged_decode", "paged_window", "ragged_paged")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_LIBS: dict[str, ctypes.CDLL] = {}
# Each wrapper adds to its ``LAUNCHES`` under this lock, and so do graph
# replays (``runtime/graphs.py``): several engines' threads launch at once.
LAUNCH_LOCK = threading.RLock()
# a thread recording a graph counts its launches here instead (``tally``)
_TALLY = threading.local()


@contextlib.contextmanager
def tally():
    """Count this thread's kernel launches apart while the block runs, in
    the Counter it yields, by kernel name: a graph's padding run and its
    capture serve no request, and only the capture's own thread launches
    into it, so the other threads' launches go on to ``LAUNCHES``."""
    prev = getattr(_TALLY, "counts", None)
    _TALLY.counts = collections.Counter()
    try:
        yield _TALLY.counts
    finally:
        _TALLY.counts = prev


def tallied(name: str) -> bool:
    """Whether this thread counts apart (``tally``); if so, one launch of
    kernel ``name`` is added to its tally."""
    counts = getattr(_TALLY, "counts", None)
    if counts is None:
        return False
    counts[name] += 1
    return True


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    """Start one nvcc into a temporary file; the caller renames it into
    place, so a concurrent build never loads a half-written library."""
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, out


def build(names=KERNELS) -> float:
    """Compile every missing library among ``names``, all nvcc processes
    started together.  Returns the wall seconds spent; raises with nvcc's
    output when a build fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [_start(n) for n in names if not _lib_path(n).exists()]
    errors = []
    for proc, tmp, out in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {out.name} (rc {proc.returncode}):"
                          f"\n{stdout}\n{stderr}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib
