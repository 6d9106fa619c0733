"""Fuzzy-logic smoothing (counterpart of ``montecarlo_risk_engine_tpu/utils/maths.py``).

``symmetric_linear_smoothing`` is the hard ``(x > 0)`` indicator when
smoothing is off and the linear ramp ``clamp((x + eps) / (2 eps), 0, 1)``
when on (reference maths.py:3-6).  Widths: default 0.05, Heston QE 0.3 for
the mass-at-zero indicator and 0.5 for the psi-switch (heston.py:227-236).
``is_fuzzy`` is a plain Python bool, set once when differentiation is
enabled (reference model.py:83-90).
"""

from __future__ import annotations

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
    on the segment i = clip(searchsorted(xp, x, right), 1, len - 1)."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, xp.shape[0] - 1)
    dx = xp[i] - xp[i - 1]
    f = fp[i - 1] + ((x - xp[i - 1]) / dx) * (fp[i] - fp[i - 1])
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)
