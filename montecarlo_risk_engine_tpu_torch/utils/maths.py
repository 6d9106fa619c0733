"""Fuzzy-logic smoothing and host-side root finding (counterpart of
``montecarlo_risk_engine_tpu/utils/maths.py``).

``symmetric_linear_smoothing`` is the hard ``(x > 0)`` indicator when
smoothing is off and the linear ramp ``clamp((x + eps) / (2 eps), 0, 1)``
when on (reference maths.py:3-6).  Widths: default 0.05, Heston QE 0.3 for
the mass-at-zero indicator and 0.5 for the psi-switch (heston.py:227-236),
binary options 1.0 (binary_option.py:38).  ``is_fuzzy`` is a plain Python
bool, set once when differentiation is enabled (reference model.py:83-90).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def symmetric_linear_smoothing(x: torch.Tensor, is_fuzzy: bool, eps: float) -> torch.Tensor:
    if not is_fuzzy:
        return (x > 0).to(x.dtype)
    return torch.clamp((x + eps) / (2.0 * eps), 0.0, 1.0)


def compute_degree_of_truth(x: torch.Tensor, is_fuzzy: bool, eps: float = 0.05) -> torch.Tensor:
    return symmetric_linear_smoothing(x, is_fuzzy, eps)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation with flat extrapolation at both ends,
    the arithmetic of ``jnp.interp``: f = fp[i-1] + ((x - xp[i-1]) / dx) df
    on the segment i = clip(searchsorted(xp, x, right), 1, K - 1), and
    fp[i-1] where |dx| is below the spacing of the dtype's epsilon.  A
    one-point curve gives i = 0 and i - 1 wraps to the last point, as a
    negative index does in ``jnp.interp``: the curve's one value everywhere.

    ``xp``, ``fp``: [K], or [*B, K] for a batch of curves (the storage
    bucket's per-product curves); ``x``: any shape, or [*B, ...] with the
    batch dimensions leading."""
    k = xp.shape[-1]
    batch = xp.shape[:-1]
    flat = x.reshape(*batch, -1).contiguous() if batch else x.contiguous()
    i = torch.clamp(torch.searchsorted(xp.contiguous(), flat, right=True), 1, k - 1)
    i0 = torch.remainder(i - 1, k)
    take = (lambda a, j: torch.gather(a, -1, j)) if batch else (lambda a, j: a[j])
    xp0, xp1, fp0, fp1 = take(xp, i0), take(xp, i), take(fp, i0), take(fp, i)
    dx = xp1 - xp0
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float64 if xp.dtype == torch.float64
                                                 else np.float32).eps))
    f = torch.where(dx0, fp0, fp0 + ((flat - xp0) / torch.where(dx0, torch.ones_like(dx), dx))
                    * (fp1 - fp0))
    first = xp[..., :1] if batch else xp[0]
    last = xp[..., -1:] if batch else xp[-1]
    f = torch.where(flat < first, fp[..., :1] if batch else fp[0], f)
    f = torch.where(flat > last, fp[..., -1:] if batch else fp[-1], f)
    return f.reshape(x.shape)


def bisection_search(func: Callable[[float], float], low: float = 1e-10, high: float = 5.0,
                     tolerance: float = 1e-12, iters: int = 100) -> Optional[float]:
    """Host-side scalar bisection with bracket expansion (JAX maths.py:43-72,
    reference maths.py:14-33): the upper end doubles up to 20 times until
    the bracket changes sign, else None.  Used at set-up time only (the CDS
    hazard bootstrap)."""
    value_low, value_high = func(low), func(high)
    cnt = 0
    while value_low * value_high > 0.0 and cnt < 20:
        high *= 2.0
        value_high = func(high)
        cnt += 1
    if value_low * value_high > 0.0:
        return None
    for _ in range(iters):
        mid = 0.5 * (low + high)
        value_mid = func(mid)
        if abs(value_mid) < tolerance or (high - low) < 1e-12:
            return mid
        if value_low * value_mid <= 0.0:
            high, value_high = mid, value_mid
        else:
            low, value_low = mid, value_mid
    return 0.5 * (low + high)
