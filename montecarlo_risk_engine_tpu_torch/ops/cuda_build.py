"""Build and load the hand-written CUDA kernels of this package.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``_build/`` (named by a hash of the source, the shared ``csrc/*.cuh`` headers
and the flags, so an edited source is rebuilt) and loaded with ``ctypes``.
A build may add flags (``extra``): K2 is built once per block tuple, its
slot roles given as ``-D`` constants.  Nothing is compiled when a module is
imported: machines without ``nvcc`` import the package and run the plain
versions on CPU tensors.

The wrappers share one calling convention (:func:`bind`, :func:`check`,
:func:`ptr`, :func:`upload`): a kernel's C function gets its argument types
at its first call and returns a ``cudaError_t``, which raises when not 0;
host tables reach the card through pinned memory, with no sync.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"

# No --use_fast_math, and no FMA contraction: every kernel is compared with a
# plain PyTorch version whose ops round one at a time.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class BuiltLibrary:
    """A loaded kernel library with its build record."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: Optional[float], log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds  # None when an existing build was reused
        self.log = log  # nvcc's output (ptxas register/spill report)


_loaded: Dict[Tuple[str, Tuple[str, ...]], BuiltLibrary] = {}


def _find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


Build = Tuple[str, Tuple[str, ...]]  # (source name, extra nvcc flags)


def load_libraries(builds: Iterable[Build]) -> Dict[Build, BuiltLibrary]:
    """Compile (where needed) and load ``csrc/<name>.cu`` with
    :data:`NVCC_FLAGS` and its extra flags for every (name, extra); the
    missing builds run as concurrent nvcc processes.  nvcc's output is kept
    beside each library, so a reused build still has its ptxas report."""
    builds = list(dict.fromkeys((name, tuple(extra)) for name, extra in builds))
    pending = {}
    for name, extra in builds:
        if (name, extra) in _loaded:
            continue
        flags = NVCC_FLAGS + extra
        src = CSRC_DIR / f"{name}.cu"
        headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
        digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        if out.exists():
            log = out.with_suffix(".log")
            _loaded[name, extra] = BuiltLibrary(ctypes.CDLL(str(out)), out, None,
                                                log.read_text() if log.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_find_nvcc(), *flags, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending[name, extra] = (proc, src, tmp, out, time.perf_counter())
    failures = []
    for key, (proc, src, tmp, out, t0) in pending.items():
        log, _ = proc.communicate()
        build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {src.name} {' '.join(key[1])}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        _loaded[key] = BuiltLibrary(ctypes.CDLL(str(out)), out, build_seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {key: _loaded[key] for key in builds}


def load_library(name: str, extra: Tuple[str, ...] = ()) -> BuiltLibrary:
    """Compile (if needed) and load ``csrc/<name>.cu`` with ``extra`` flags."""
    return load_libraries([(name, extra)])[name, tuple(extra)]


def bind(lib: ctypes.CDLL, symbol: str, argtypes: Sequence):
    """``lib``'s C function ``symbol``, its ``argtypes`` and its
    ``cudaError_t`` result type set at the first call."""
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(rc: int, kernel: str) -> None:
    """Raise for a launch's non-zero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {rc}")


def ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address, None (a null pointer) for None."""
    return None if x is None else x.data_ptr()


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: to the card through pinned memory, with
    no sync; a plain copy elsewhere."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def launch_sizes(num_params: int, chunk: int, per_launch: int) -> List[int]:
    """The tangent counts of a forward-mode jacobian's launches: sweeps of
    ``chunk`` of the ``num_params`` directions, each in launches of at most
    ``per_launch`` tangents."""
    sizes = []
    for start in range(0, num_params, chunk):
        c = min(chunk, num_params - start)
        sizes += [min(per_launch, c - j) for j in range(0, c, per_launch)]
    return sizes


def ulps_apart(a: torch.Tensor, b: torch.Tensor) -> float:
    """The most units in the last place between two float64 tensors of nan
    at the same places (inf where the nans differ): how a kernel's output
    is held to its plain version's."""
    if not torch.equal(a.isnan(), b.isnan()):
        return math.inf
    keep = ~a.isnan()
    if not bool(keep.any()):
        return 0.0
    lo = torch.iinfo(torch.int64).min
    ia, ib = a[keep].view(torch.int64), b[keep].view(torch.int64)
    ia, ib = (torch.where(x < 0, lo - x, x) for x in (ia, ib))
    return float((ia - ib).abs().max())
