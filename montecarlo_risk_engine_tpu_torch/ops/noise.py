"""Correlated-noise application (counterpart of ``montecarlo_risk_engine_tpu/ops/noise.py``).

``noise = z @ L.T`` over the trailing axis.  The JAX package writes this as
a broadcast multiply-add to keep a sim_dim-wide contraction off the TPU's
matrix unit; on a GPU it is one batched product.
"""

from __future__ import annotations

import torch


def correlate_noise(z: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """z [..., s] with transform [k, s] (one matrix for every leading index)
    or [T, k, s] (one per leading axis of z [T, N, s]) -> [..., k]."""
    if transform.dim() == 2 or (transform.dim() == 3 and z.dim() == 3):
        return z @ transform.mT
    raise ValueError(f"correlate_noise: unsupported ranks z={z.dim()}, transform={transform.dim()}")
