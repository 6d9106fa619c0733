"""Correlated-noise application (counterpart of ``montecarlo_risk_engine_tpu/ops/noise.py``).

``noise = z @ L.T`` over the trailing axis, as multiply-adds over that short
axis (the JAX package's broadcast multiply-add, there to keep a
sim_dim-wide contraction off the TPU's matrix unit).  Here the fixed order is
the point: a library's matrix product may pick another kernel, and another
rounding, for another row count, and a path's value must not depend on how
many paths share a call (a rank of a path-sharded run holds a share of them,
parallel/mesh.py).  :func:`matmul_t` is the same contraction for every
per-path product over a short axis (regression bases against their
coefficients too).
"""

from __future__ import annotations

import torch


def matmul_t(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.mT`` for x [..., N, K] and w [..., M, K] (leading axes
    broadcast): the products summed in index order k = 0 .. K-1, the same
    float operations for every row whatever N is."""
    out = x[..., 0, None] * w[..., None, :, 0]
    for k in range(1, x.shape[-1]):
        out = out + x[..., k, None] * w[..., None, :, k]
    return out


def correlate_noise(z: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """z [..., s] with transform [k, s] (one matrix for every leading index)
    or [T, k, s] (one per leading axis of z [T, N, s]) -> [..., k]."""
    if transform.dim() == 2 or (transform.dim() == 3 and z.dim() == 3):
        return matmul_t(z, transform)
    raise ValueError(f"correlate_noise: unsupported ranks z={z.dim()}, transform={transform.dim()}")
