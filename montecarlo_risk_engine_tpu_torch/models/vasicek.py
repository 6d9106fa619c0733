"""Vasicek one-factor short-rate model.

Counterpart of ``montecarlo_risk_engine_tpu/models/vasicek.py``.  State =
[r, log_B] with log_B the left-Riemann numeraire accumulator (the integral
of r dt on the start state of each step, reference quirk Q3, kept so
exposures match).  Params (reference order): rate, volatility, mean,
mean_reversion_speed.  Exact OU (ANALYTICAL), Euler and Milstein (= Euler)
steps with their inversions; alone under ANALYTICAL the model takes K2 as
one exact "vasicek" block (vasicek.py:55-109), inside a ModelConfig an
Euler one.
"""

from __future__ import annotations

import math

import torch

from montecarlo_risk_engine_tpu_torch.config import SimulationScheme
from montecarlo_risk_engine_tpu_torch.models.base import Model, per_row
from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import KernelBlock
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequestType


class VasicekModel(Model):
    kernel_schemes = (SimulationScheme.ANALYTICAL,)

    def __init__(self, calibration_date: float, rate: float, mean: float,
                 mean_reversion_speed: float, volatility: float, asset_id: str | None = None):
        super().__init__(calibration_date=calibration_date, state_dim=2, asset_ids=[asset_id])
        self._init = (float(rate), float(volatility), float(mean), float(mean_reversion_speed))

    def _initial_values(self):
        return self._init

    def get_model_param_names(self):
        return ["rate", "volatility", "mean", "mean_reversion_speed"]

    def init_state(self, params, num_paths):
        r0 = params[0].expand(num_paths)
        return torch.stack([r0, torch.zeros_like(r0)], dim=-1)

    def covariance_matrix(self, params, delta_t):
        # Exact conditional variance of the OU increment (vasicek.py:115-120).
        _, sigma, _, a = params
        decay = torch.exp(-a * delta_t)
        return ((sigma * sigma / (2.0 * a)) * (1.0 - decay * decay)).reshape(1, 1)

    def analytic_factor_loadings(self, params):
        return [(params[3], params[1])]

    def step_analytical(self, params, t1, t2, state, corr_noise):
        # r' = theta + (r - theta) e^{-a dt} + eta (exact), log_B += r dt
        # (left Riemann; vasicek.py:122-130).
        _, _, theta, a = params
        dt = t2 - t1
        r = state[:, 0:1]
        log_b = state[:, 1:2] + r * dt
        r_next = theta + (r - theta) * torch.exp(-a * dt) + corr_noise
        return torch.cat([r_next, log_b], dim=-1)

    def step_euler(self, params, t1, t2, state, corr_noise):
        # vasicek.py:132-138
        _, sigma, theta, a = params
        dt = t2 - t1
        r = state[:, 0:1]
        log_b = state[:, 1:2] + r * dt
        r_next = r + a * (theta - r) * dt + sigma * math.sqrt(dt) * corr_noise
        return torch.cat([r_next, log_b], dim=-1)

    step_milstein = step_euler  # constant diffusion (vasicek.py:140-141)

    def invert_noise(self, params, scheme, t1, t2, state, next_state):
        # Exact-OU or Euler residual of the r column; log_B carries no noise
        # (vasicek.py:65-77).
        _, sigma, theta, a = params
        dt = t2 - t1
        r, r_next = state[:, 0:1], next_state[:, 0:1]
        if scheme == SimulationScheme.ANALYTICAL:
            return r_next - theta - (r - theta) * torch.exp(-a * dt)
        return (r_next - r - a * (theta - r) * dt) / (sigma * math.sqrt(dt))

    def kernel_block(self, scheme, param_base=0):
        if scheme not in (SimulationScheme.ANALYTICAL, SimulationScheme.EULER):
            return None
        return KernelBlock("vasicek",
                           "exact" if scheme == SimulationScheme.ANALYTICAL else "euler",
                           param_base, 2, 1)

    def bond_price(self, params, t1, t2, rate_state):
        """Closed-form zero bond P(t1, t2 | r) (vasicek.py:143-149)."""
        _, sigma, theta, a = params
        dt = per_row(t2 - t1, rate_state)
        b = (1.0 - torch.exp(-a * dt)) / a
        alpha = ((theta - sigma * sigma / (2.0 * a * a)) * (b - dt)
                 - (sigma * sigma / (4.0 * a)) * b * b)
        return torch.exp(alpha) * torch.exp(-b * rate_state)

    def compute_bond_price(self, params, t1, t2, rate_state):
        """The reference's name of :meth:`bond_price` (JAX vasicek.py:152-153)."""
        return self.bond_price(params, t1, t2, rate_state)

    def resolve_obs(self, params, kind, asset_id, t1, t2, state):
        # vasicek.py:155-171
        if kind == AtomicRequestType.SPOT:
            return self._col(state, 0)
        if kind == AtomicRequestType.DISCOUNT_FACTOR:
            return self.bond_price(params, self.calibration_date, t1, self._col(state, 0))
        if kind == AtomicRequestType.FORWARD_RATE:
            # The conditional bond price P(t1, t2), which Bond consumes as a
            # discount factor (vasicek.py:161-165).
            return self.bond_price(params, t1, t2, self._col(state, 0))
        if kind == AtomicRequestType.LIBOR_RATE:
            p = self.bond_price(params, t1, t2, self._col(state, 0))
            return (1.0 / p - 1.0) / per_row(t2 - t1, p)
        if kind == AtomicRequestType.NUMERAIRE:
            return torch.exp(self._col(state, 1))
        raise NotImplementedError(f"Request type {kind} not supported by VasicekModel.")
