"""Regression bases and the least-squares fit of the LSM regressions.

Counterpart of ``montecarlo_risk_engine_tpu/utils/regression.py``: the
monomial basis and ``fit_least_squares`` by normal equations with column
equilibration, optional per-path weights and a scale-relative ridge.  Every
path-axis sum is a ``fixed_tree_sum`` (JAX regression.py:59-96), over every
rank's paths under a path sharding, so the coefficients have the same bits on
any number of ranks; the solve's inputs are then replicated and every rank
solves the same system.  Both take leading batch dimensions, so a bucket of
products fits in one batched solve.
"""

from __future__ import annotations

from typing import Optional

import torch

from montecarlo_risk_engine_tpu_torch.metrics.metrics import fixed_tree_sum, global_count


class RegressionFunction:
    def __init__(self, degree: int):
        self.degree = degree

    def get_degree(self) -> int:
        """Number of basis columns (reference regression.py:7-8)."""
        return self.degree + 1

    def get_regression_matrix(self, explanatory):
        raise NotImplementedError


class PolynomialRegression(RegressionFunction):
    """Monomial basis [1, x, x^2, ...] along a new last axis (reference
    regression.py:10-15)."""

    def get_regression_matrix(self, explanatory):
        return torch.stack([explanatory ** k for k in range(self.degree + 1)], dim=-1)


# The reference's misspelled public name (JAX regression.py:42), so user
# scripts port unchanged.
PolyomialRegression = PolynomialRegression


def fit_least_squares(A: torch.Tensor, Y: torch.Tensor, ridge_rel: Optional[float] = None,
                      weights: Optional[torch.Tensor] = None, sharding=None) -> torch.Tensor:
    """``argmin sum_n w_n (A c - Y)_n^2`` for A [..., N, deg], Y [..., N, S]
    (or [..., N]) and optional weights [..., N]; returns coeffs [..., S, deg]
    (regression.py:45-96).

    Columns are scaled to unit RMS before the Gram solve (weighted normal
    equations A'WA c = A'WY), and a ridge of ``ridge_rel`` (default ~1e3
    machine epsilons: 1e-10 in float64, 1e-4 in float32) times the mean Gram
    diagonal keeps degenerate bases (a constant explanatory at t = 0)
    solvable.  The solve reports no error for a singular system, as XLA's
    does not.  ``sharding``: N is this rank's share of the paths."""
    if Y.dim() == A.dim() - 1:
        Y = Y[..., None]
    n, deg = A.shape[-2:]
    n = global_count(n, sharding)
    col_scale = torch.clamp(torch.sqrt(fixed_tree_sum(A * A, -2, sharding) / n), min=1e-30)
    A_s = A / col_scale[..., None, :]
    A_w = A_s if weights is None else A_s * weights[..., None]
    # the Gram rows and right-hand sides in one tree sum of the [..., N, deg,
    # deg + S] products A_w[n, d] [A_s | Y][n, j]: each entry the bits of its
    # own tree sum, in one launch per halving
    lead = torch.broadcast_shapes(A_s.shape[:-1], Y.shape[:-1])
    cols = torch.cat([A_s.expand(lead + (deg,)), Y.expand(lead + Y.shape[-1:])], dim=-1)
    both = fixed_tree_sum(A_w[..., :, :, None] * cols[..., :, None, :], -3, sharding)
    gram, rhs = both[..., :deg], both[..., deg:]
    if ridge_rel is None:
        ridge_rel = 1e-10 if torch.finfo(A.dtype).bits >= 64 else 1e-4
    scale = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1) / deg
    eye = torch.eye(deg, dtype=A.dtype, device=A.device)
    gram = gram + (ridge_rel * scale + 1e-30)[..., None, None] * eye
    # LU factor and solve, the steps of torch.linalg.solve_ex with the same
    # numbers: solve's own forward-mode rule is wrong under a second forward
    # tangent (torch.func.jvp of jvp), and these two are differentiated
    # correctly to every order
    lu, pivots, _ = torch.linalg.lu_factor_ex(gram)
    coeffs = torch.linalg.lu_solve(lu, pivots, rhs)
    return (coeffs / col_scale[..., :, None]).mT
