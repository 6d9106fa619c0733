"""Build and load the hand-written CUDA kernels of this package.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``_build/`` (named by a hash of the source and flags, so an edited source is
rebuilt) and loaded with ``ctypes``.  Nothing is compiled when a module is
imported: machines without ``nvcc`` import the package and run the plain
versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

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


_loaded: Dict[str, BuiltLibrary] = {}


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


def load_libraries(names: Iterable[str]) -> Dict[str, BuiltLibrary]:
    """Compile (where needed) and load ``csrc/<name>.cu`` for every name;
    the missing builds run as concurrent nvcc processes."""
    names = list(dict.fromkeys(names))
    pending = {}
    for name in names:
        if name in _loaded:
            continue
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        if out.exists():
            _loaded[name] = BuiltLibrary(ctypes.CDLL(str(out)), out, None, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, src, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, src, tmp, out, t0) in pending.items():
        log, _ = proc.communicate()
        build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {src.name}:\n{log}")
            continue
        os.replace(tmp, out)
        _loaded[name] = BuiltLibrary(ctypes.CDLL(str(out)), out, build_seconds, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: _loaded[name] for name in names}


def load_library(name: str) -> BuiltLibrary:
    """Compile (if needed) and load ``csrc/<name>.cu``."""
    return load_libraries([name])[name]
