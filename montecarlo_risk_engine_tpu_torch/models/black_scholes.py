"""Single-asset Black-Scholes (GBM) model.

Counterpart of ``montecarlo_risk_engine_tpu/models/black_scholes.py``.
State = [S]; params (reference order): spot, volatility, rate.  Exact
log-normal (ANALYTICAL) and Euler steps with their inversions, and the
Milstein step (JAX black_scholes.py:114; the reference declares MILSTEIN but
never implements it, quirk Q1), which runs on the engine; alone under
ANALYTICAL the model takes K2 as one exact "bs" block
(black_scholes.py:50-92), inside a ModelConfig an Euler one.
"""

from __future__ import annotations

import math

import torch

from montecarlo_risk_engine_tpu_torch.config import SimulationScheme
from montecarlo_risk_engine_tpu_torch.models.base import Model
from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import KernelBlock
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequestType


class BlackScholesModel(Model):
    kernel_schemes = (SimulationScheme.ANALYTICAL,)

    def __init__(self, calibration_date: float, spot: float, rate: float, sigma: float,
                 asset_id: str | None = None):
        super().__init__(calibration_date=calibration_date,
                         asset_ids=[asset_id] if asset_id else None)
        self._init = (float(spot), float(sigma), float(rate))

    def _initial_values(self):
        return self._init

    def get_model_param_names(self):
        return ["spot", "volatility", "rate"]

    def init_state(self, params, num_paths):
        return params[0].expand(num_paths, 1)

    def covariance_matrix(self, params, delta_t):
        # black_scholes.py:98-100
        sigma = params[1]
        return (sigma * sigma * delta_t).reshape(1, 1)

    def analytic_factor_loadings(self, params):
        return [(0.0, params[1])]

    def step_analytical(self, params, t1, t2, state, corr_noise):
        # S' = S exp(r dt - sigma^2 dt / 2 + eta), eta ~ N(0, sigma^2 dt)
        # (black_scholes.py:102-107; the noise carries sigma sqrt(dt)).
        _, sigma, rate = params
        dt = t2 - t1
        return state * torch.exp(rate * dt - 0.5 * sigma * sigma * dt + corr_noise)

    def step_euler(self, params, t1, t2, state, corr_noise):
        # S' = S + r S dt + sigma S sqrt(dt) z (black_scholes.py:109).
        _, sigma, rate = params
        dt = t2 - t1
        return state + rate * state * dt + sigma * state * math.sqrt(dt) * corr_noise

    def step_milstein(self, params, t1, t2, state, corr_noise):
        # Euler + 0.5 sigma^2 S (dW^2 - dt) (black_scholes.py:114-125).
        _, sigma, rate = params
        dt = t2 - t1
        dw = math.sqrt(dt) * corr_noise
        return (state + rate * state * dt + sigma * state * dw
                + 0.5 * sigma * sigma * state * (dw * dw - dt))

    def invert_noise(self, params, scheme, t1, t2, state, next_state):
        # black_scholes.py:56-63
        _, sigma, rate = params
        dt = t2 - t1
        if scheme == SimulationScheme.ANALYTICAL:
            return torch.log(next_state / state) - (rate - 0.5 * sigma * sigma) * dt
        if scheme != SimulationScheme.EULER:
            raise NotImplementedError(f"BlackScholesModel does not invert {scheme.name}")
        return (next_state / state - 1.0 - rate * dt) / (sigma * math.sqrt(dt))

    def kernel_block(self, scheme, param_base=0):
        if scheme not in (SimulationScheme.ANALYTICAL, SimulationScheme.EULER):
            return None
        return KernelBlock("bs", "exact" if scheme == SimulationScheme.ANALYTICAL else "euler",
                           param_base, 1, 1)

    def resolve_obs(self, params, kind, asset_id, t1, t2, state):
        # black_scholes.py:127-140: constant short-rate closed forms.
        rate = params[2]
        if kind == AtomicRequestType.SPOT:
            return self._col(state, 0)
        if kind == AtomicRequestType.DISCOUNT_FACTOR:
            return torch.exp(-rate * (t1 - self.calibration_date))
        if kind == AtomicRequestType.FORWARD_RATE:
            return torch.exp(rate * (t2 - t1))
        if kind == AtomicRequestType.LIBOR_RATE:
            return (torch.exp(rate * (t2 - t1)) - 1.0) / (t2 - t1)
        if kind == AtomicRequestType.NUMERAIRE:
            return torch.exp(rate * (t1 - self.calibration_date))
        raise NotImplementedError(f"Request type {kind} not supported by BlackScholesModel.")
