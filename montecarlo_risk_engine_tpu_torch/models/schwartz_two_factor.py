"""Schwartz two-factor commodity spot model around a baseline forward curve.

Counterpart of ``montecarlo_risk_engine_tpu/models/schwartz_two_factor.py``.
log S(t) = log F0(t) + x(t) + y(t): x a short-term OU factor, y a long-term
Brownian factor with drift.  State = [log S, x, y]; simulation_dim = 2.
Params (reference order): rate, short_term_mean_reversion, short_term_vol,
long_term_drift, long_term_vol, rho.  F0 is interpolated linearly with flat
extrapolation (``jnp.interp``).  The correlation rho is a parameter, so
alone the model takes K2 as one "s2f" block that draws two raw normals and
correlates them itself (schwartz_two_factor.py:159-197); a ModelConfig has
no s2f block.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch.config import SimulationScheme
from montecarlo_risk_engine_tpu_torch.models.base import Model, like
from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import KernelBlock
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequestType
from montecarlo_risk_engine_tpu_torch.utils.maths import interp


class SchwartzTwoFactorModel(Model):
    kernel_schemes = (SimulationScheme.ANALYTICAL, SimulationScheme.EULER,
                      SimulationScheme.MILSTEIN)

    def __init__(self, calibration_date: float, curve_times: Sequence[float],
                 curve_values: Sequence[float], rate: float, short_term_mean_reversion: float,
                 short_term_vol: float, long_term_drift: float, long_term_vol: float,
                 rho: float, asset_id: str | None = None):
        super().__init__(calibration_date=calibration_date,
                         asset_ids=[asset_id] if asset_id else None, simulation_dim=2,
                         state_dim=3)
        if len(curve_times) != len(curve_values):
            raise ValueError("curve_times and curve_values must have identical lengths.")
        if len(curve_times) < 2:
            raise ValueError("At least two curve points are required.")
        if any(v <= 0.0 for v in curve_values):
            raise ValueError("Curve values must be strictly positive.")
        self.curve_times = np.asarray([float(t) for t in curve_times], dtype=np.float64)
        self.curve_values = np.asarray([float(v) for v in curve_values], dtype=np.float64)
        self._init = (float(rate), float(short_term_mean_reversion), float(short_term_vol),
                      float(long_term_drift), float(long_term_vol), float(rho))

    def _initial_values(self):
        return self._init

    def get_model_param_names(self):
        return ["rate", "short_term_mean_reversion", "short_term_vol", "long_term_drift",
                "long_term_vol", "rho"]

    def _log_curve(self, t, ref: torch.Tensor) -> torch.Tensor:
        return torch.log(interp(like(t, ref), like(self.curve_times, ref),
                                like(self.curve_values, ref)))

    def init_state(self, params, num_paths):
        log_spot = self._log_curve(self.calibration_date, params[0]).expand(num_paths)
        zeros = torch.zeros_like(log_spot)
        return torch.stack([log_spot, zeros, zeros], dim=-1)

    def correlation_matrix(self, params, scheme):
        rho = params[5]
        one = torch.ones_like(rho)
        return torch.stack([torch.stack([one, rho]), torch.stack([rho, one])])

    def covariance_matrix(self, params, delta_t):
        # Exact one-step covariance of (x, y) with the kappa -> 0 limit
        # (schwartz_two_factor.py:102-112).
        _, kappa, sig_s, _, sig_l, rho = params
        near_zero = torch.abs(kappa) < 1e-12
        kappa_safe = torch.where(near_zero, torch.ones_like(kappa), kappa)
        var_ou = sig_s * sig_s * (1.0 - torch.exp(-2.0 * kappa_safe * delta_t)) / (2.0 * kappa_safe)
        var_short = torch.where(near_zero, sig_s * sig_s * delta_t, var_ou)
        var_long = sig_l * sig_l * delta_t
        cov = rho * torch.sqrt(torch.clamp(var_short * var_long, min=0.0))
        return torch.stack([torch.stack([var_short, cov]), torch.stack([cov, var_long])])

    def analytic_factor_loadings(self, params):
        _, kappa, sig_s, _, sig_l, _ = params
        return [(kappa, sig_s), (0.0, sig_l)]

    def step_analytical(self, params, t1, t2, state, corr_noise):
        _, kappa, _, mu_l, _, _ = params
        dt = t2 - t1
        decay = torch.where(torch.abs(kappa) < 1e-12, torch.ones_like(kappa),
                            torch.exp(-kappa * dt))
        x_next = state[:, 1] * decay + corr_noise[:, 0]
        y_next = state[:, 2] + mu_l * dt + corr_noise[:, 1]
        log_spot = self._log_curve(t2, kappa) + x_next + y_next
        return torch.stack([log_spot, x_next, y_next], dim=-1)

    def step_euler(self, params, t1, t2, state, corr_noise):
        _, kappa, sig_s, mu_l, sig_l, _ = params
        dt = t2 - t1
        sqrt_dt = math.sqrt(dt)
        x, y = state[:, 1], state[:, 2]
        x_next = x - kappa * x * dt + sig_s * sqrt_dt * corr_noise[:, 0]
        y_next = y + mu_l * dt + sig_l * sqrt_dt * corr_noise[:, 1]
        log_spot = self._log_curve(t2, kappa) + x_next + y_next
        return torch.stack([log_spot, x_next, y_next], dim=-1)

    step_milstein = step_euler  # constant diffusion coefficients

    def invert_noise(self, params, scheme, t1, t2, state, next_state):
        # (x, y) are affine in the noise columns, log S is derived
        # (schwartz_two_factor.py:139-155).
        _, kappa, sig_s, mu_l, sig_l, _ = params
        dt = t2 - t1
        x, y = state[:, 1:2], state[:, 2:3]
        x_n, y_n = next_state[:, 1:2], next_state[:, 2:3]
        if scheme == SimulationScheme.ANALYTICAL:
            decay = torch.where(torch.abs(kappa) < 1e-12, torch.ones_like(kappa),
                                torch.exp(-kappa * dt))
            nx = x_n - x * decay
            ny = y_n - y - mu_l * dt
        else:
            sqrt_dt = math.sqrt(dt)
            nx = (x_n - x + kappa * x * dt) / (sig_s * sqrt_dt)
            ny = (y_n - y - mu_l * dt) / (sig_l * sqrt_dt)
        return torch.cat([nx, ny], dim=-1)

    def kernel_block(self, scheme, param_base=0):
        if scheme not in self.kernel_schemes:
            return None
        return KernelBlock("s2f", "exact" if scheme == SimulationScheme.ANALYTICAL else "euler",
                           param_base, 3, 2,
                           curve_times=tuple(float(t) for t in self.curve_times),
                           curve_vals=tuple(float(v) for v in self.curve_values))

    def resolve_obs(self, params, kind, asset_id, t1, t2, state):
        # schwartz_two_factor.py:199-212: constant-rate discounting.
        rate = params[0]
        if kind == AtomicRequestType.SPOT:
            return torch.exp(self._col(state, 0))
        if kind == AtomicRequestType.DISCOUNT_FACTOR:
            return torch.exp(-rate * (t1 - self.calibration_date))
        if kind == AtomicRequestType.FORWARD_RATE:
            return torch.exp(rate * (t2 - t1))
        if kind == AtomicRequestType.LIBOR_RATE:
            return (torch.exp(rate * (t2 - t1)) - 1.0) / (t2 - t1)
        if kind == AtomicRequestType.NUMERAIRE:
            return torch.exp(rate * (t1 - self.calibration_date))
        raise NotImplementedError(
            f"Request type {kind} not supported by SchwartzTwoFactorModel.")
