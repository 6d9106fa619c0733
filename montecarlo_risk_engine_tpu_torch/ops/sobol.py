"""Sobol low-discrepancy draws for the path engine (quasi-Monte Carlo).

Counterpart of ``montecarlo_risk_engine_tpu/ops/sobol.py``:

  * :func:`direction_numbers`: scipy's Joe-Kuo table (21,201 dimensions)
    as a host [dims, 32] array, built once per run;
  * :func:`sobol_uint32`: point ``p`` of the sequence is path ``p``, by the
    Gray-code formula x_p = XOR over the set bits b of gray(p) of v_b, so
    every path is computed on its own, with no sequential state (a rank of a
    path-sharded run takes its global paths ``path_offset + path_stride *
    i``); a 32-bit digital shift (``rng.qmc_shift``) randomises each
    dimension;
  * :func:`sobol_uniforms`: (x + 0.5) 2^-32, never 0 or 1; normals through
    the inverse normal CDF (``torch.special.ndtri``);
  * :func:`brownian_bridge_matrix`: the orthogonal rotation that puts a
    path's coarse structure (terminal value, then midpoints level by level)
    on the leading Sobol dimensions; a numpy copy of the JAX package's.

Torch's uint32 lacks shifts and XOR on several backends, so the words are
int64 tensors holding values in [0, 2^32).  None of this is a Pallas kernel
in the JAX package (it is XLA code there); it stays plain torch here.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

_BITS = 32
_MAXDIM = 21201  # scipy's Joe-Kuo table size


def direction_numbers(num_dims: int) -> np.ndarray:
    """Joe-Kuo direction numbers as a host uint32 array [num_dims, 32]:
    row j, column b is XORed into dimension j when bit b (LSB first) of the
    Gray-coded point index is set."""
    if num_dims > _MAXDIM:
        raise ValueError(
            f"Sobol dimension {num_dims} exceeds the Joe-Kuo table ({_MAXDIM}); reduce "
            "num_steps x factors, or use the pseudo-random sampler")
    try:
        from scipy.stats import _sobol

        v = np.zeros((num_dims, _BITS), dtype=np.uint64)
        _sobol._initialize_v(v, dim=num_dims, bits=_BITS)
    except (ImportError, AttributeError, TypeError) as exc:
        raise RuntimeError(
            "scipy's private Joe-Kuo initialiser (scipy.stats._sobol._initialize_v) is "
            f"missing or changed in this scipy: {exc!r}") from exc
    return v.astype(np.uint32)


def brownian_bridge_matrix(dt) -> np.ndarray:
    """Standardised Brownian-bridge rotation for an irregular substep grid.

    ``dt``: per-substep variances [T] (0 for a degenerate interval).
    Returns M [T, U], U the number of dt > 0 substeps, such that for U iid
    standard normals z in bridge order (z_0 the terminal value, z_1 the
    midpoint, then finer midpoints level by level) the driver normal of
    substep k is (M @ z)[k].  M is orthogonal on its nonzero rows, so the
    joint law is unchanged; only which Sobol dimension carries which part
    of the path's variance moves."""
    dt = np.asarray(dt, dtype=np.float64)
    num_sub = int(dt.shape[0])
    pos = np.flatnonzero(dt > 0.0)
    num_live = int(pos.shape[0])
    if num_live == 0:
        return np.zeros((num_sub, 0), dtype=np.float64)
    t = np.cumsum(dt[pos])
    # w_rows[u]: coefficients of W(t[u]) over the bridge-ordered z.
    w_rows = np.zeros((num_live, num_live), dtype=np.float64)
    w_rows[num_live - 1, 0] = np.sqrt(t[num_live - 1])
    z_next = 1
    segments = deque([(-1, num_live - 1)])  # known-index pairs; -1 = time 0
    while segments:
        lo, hi = segments.popleft()
        if hi - lo <= 1:
            continue
        mid = (lo + hi + 1) // 2
        t_lo = t[lo] if lo >= 0 else 0.0
        w_lo = w_rows[lo] if lo >= 0 else 0.0
        alpha = (t[hi] - t[mid]) / (t[hi] - t_lo)
        stddev = np.sqrt((t[mid] - t_lo) * (t[hi] - t[mid]) / (t[hi] - t_lo))
        w_rows[mid] = alpha * w_lo + (1.0 - alpha) * w_rows[hi]
        w_rows[mid, z_next] += stddev
        z_next += 1
        segments.append((lo, mid))
        segments.append((mid, hi))
    # Increment rows standardised to unit variance (the model step applies
    # its own transition stddev to the driver normal).
    out = np.zeros((num_sub, num_live), dtype=np.float64)
    prev = np.zeros(num_live, dtype=np.float64)
    for u, k in enumerate(pos):
        out[k] = (w_rows[u] - prev) / np.sqrt(dt[k])
        prev = w_rows[u]
    return out


def sobol_uint32(num_paths: int, vtab, shift=None, device="cpu", path_offset: int = 0,
                 path_stride: int = 1) -> torch.Tensor:
    """Sobol words of points ``path_offset + path_stride * i``, i = 0 ..
    num_paths - 1: [num_paths, d] int64 in [0, 2^32).  ``vtab``: [d, 32]
    direction numbers (numpy or tensor); ``shift``: optional [d]
    digital-shift words."""
    v = torch.as_tensor(np.asarray(vtab, dtype=np.int64) if not isinstance(vtab, torch.Tensor)
                        else vtab, dtype=torch.int64, device=device)
    idx = (torch.arange(num_paths, dtype=torch.int64, device=device)[:, None] * path_stride
           + path_offset)
    gray = idx ^ (idx >> 1)
    x = torch.zeros((num_paths, v.shape[0]), dtype=torch.int64, device=device)
    for b in range(_BITS):
        x = x ^ (((gray >> b) & 1) * v[None, :, b])
    if shift is not None:
        x = x ^ torch.as_tensor(shift, dtype=torch.int64, device=device)[None, :]
    return x


def sobol_uniforms(num_paths: int, vtab, shift, dtype, device="cpu", path_offset: int = 0,
                   path_stride: int = 1) -> torch.Tensor:
    """Scrambled Sobol uniforms in (0, 1): [num_paths, d]."""
    x = sobol_uint32(num_paths, vtab, shift, device, path_offset, path_stride)
    return (x.to(dtype) + 0.5) * (2.0 ** -32)


def sobol_normals(num_paths: int, vtab, shift, dtype, device="cpu") -> torch.Tensor:
    """Scrambled Sobol standard normals by the inverse CDF: [num_paths, d]."""
    return torch.special.ndtri(sobol_uniforms(num_paths, vtab, shift, dtype, device))
