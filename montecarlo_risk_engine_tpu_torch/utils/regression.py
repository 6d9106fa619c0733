"""Regression bases and the least-squares fit of the LSM exposures.

Counterpart of ``montecarlo_risk_engine_tpu/utils/regression.py``: the
monomial basis and ``fit_least_squares`` by normal equations with column
equilibration and a scale-relative ridge.  The JAX package reduces the path
axis in a fixed pairwise order (``fixed_tree_sum``) for its sharding
determinism contract; the port runs on one card and uses ``torch.sum``.
"""

from __future__ import annotations

import torch


class RegressionFunction:
    def __init__(self, degree: int):
        self.degree = degree

    def get_degree(self) -> int:
        """Number of basis columns (reference regression.py:7-8)."""
        return self.degree + 1

    def get_regression_matrix(self, explanatory):
        raise NotImplementedError


class PolynomialRegression(RegressionFunction):
    """Monomial basis [1, x, x^2, ...] (reference regression.py:10-15)."""

    def get_regression_matrix(self, explanatory):
        return torch.stack([explanatory ** k for k in range(self.degree + 1)], dim=1)


def fit_least_squares(A: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``argmin ||A c - Y||^2`` for A [N, deg], Y [N, S] (or [N]); returns
    coeffs [S, deg] (regression.py:45-96).

    Columns are scaled to unit RMS before the Gram solve, and a ridge of
    ~1e3 machine epsilons (1e-10 in float64, 1e-4 in float32) times the mean
    Gram diagonal keeps degenerate bases (a constant explanatory at t = 0)
    solvable.  The solve reports no error
    for a singular system, as XLA's does not."""
    if Y.dim() == 1:
        Y = Y[:, None]
    n, deg = A.shape
    col_scale = torch.clamp(torch.sqrt(torch.sum(A * A, dim=0) / n), min=1e-30)
    A_s = A / col_scale[None, :]
    gram = torch.stack([torch.sum(A_s[:, d:d + 1] * A_s, dim=0) for d in range(deg)])
    ridge_rel = 1e-10 if torch.finfo(A.dtype).bits >= 64 else 1e-4
    scale = torch.diagonal(gram).sum() / deg
    gram = gram + (ridge_rel * scale + 1e-30) * torch.eye(deg, dtype=A.dtype, device=A.device)
    rhs = torch.stack([torch.sum(A_s[:, d:d + 1] * Y, dim=0) for d in range(deg)])
    coeffs = torch.linalg.solve_ex(gram, rhs).result
    return (coeffs / col_scale[:, None]).mT
