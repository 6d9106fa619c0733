"""Multi-asset Black-Scholes model with user correlation.

Counterpart of ``montecarlo_risk_engine_tpu/models/black_scholes_multi.py``.
State = [S_1 .. S_n]; one constant rate.  Params (reference order):
spots..., volatilities..., rate, named ``spot[a]``, ``volatility[a]``,
``rate``.  The correlation is configuration, not a parameter.  Alone under
ANALYTICAL the model takes K2 as one exact "bs_multi" block whose static
Cholesky factor is that of the correlation (black_scholes_multi.py:83-110);
inside a ModelConfig it is an Euler block.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch.config import SimulationScheme
from montecarlo_risk_engine_tpu_torch.models.base import Model
from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import KernelBlock
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequestType


class BlackScholesMulti(Model):
    kernel_schemes = (SimulationScheme.ANALYTICAL,)

    def __init__(self, calibration_date: float, rate: float, asset_ids: Sequence[str],
                 spots: Sequence[float], volatilities: Sequence[float], correlation_matrix):
        super().__init__(calibration_date=calibration_date, simulation_dim=len(asset_ids),
                         state_dim=len(spots), asset_ids=asset_ids)
        self._init = tuple(float(s) for s in spots) + tuple(float(v) for v in volatilities) \
            + (float(rate),)
        self._corr = np.asarray(correlation_matrix, dtype=np.float64)

    def _initial_values(self):
        return self._init

    def get_model_param_names(self) -> List[str]:
        return ([f"spot[{a}]" for a in self.asset_ids]
                + [f"volatility[{a}]" for a in self.asset_ids] + ["rate"])

    def _spots(self, params):
        return torch.stack(params[:self.num_assets])

    def _vols(self, params):
        return torch.stack(params[self.num_assets:2 * self.num_assets])

    def _rate(self, params):
        return params[2 * self.num_assets]

    def init_state(self, params, num_paths):
        return self._spots(params).expand(num_paths, self.num_assets)

    def correlation_matrix(self, params, scheme):
        return torch.as_tensor(self._corr, dtype=params[0].dtype, device=params[0].device)

    def covariance_matrix(self, params, delta_t):
        # sigma_i sigma_j rho_ij dt (black_scholes_multi.py:118-121)
        vols = self._vols(params)
        return torch.outer(vols, vols) * self.correlation_matrix(params, None) * delta_t

    def analytic_factor_loadings(self, params):
        return [(0.0, v) for v in self._vols(params)]

    def step_analytical(self, params, t1, t2, state, corr_noise):
        dt = t2 - t1
        sigma = self._vols(params)[None, :]
        drift = (self._rate(params) - 0.5 * sigma * sigma) * dt
        return state * torch.exp(drift + corr_noise)

    def step_euler(self, params, t1, t2, state, corr_noise):
        dt = t2 - t1
        rate = self._rate(params)
        sigma = self._vols(params)[None, :]
        return state + rate * state * dt + sigma * state * math.sqrt(dt) * corr_noise

    def invert_noise(self, params, scheme, t1, t2, state, next_state):
        # Columnwise: each asset is driven by its own (already correlated)
        # Brownian (black_scholes_multi.py:70-78).
        rate = self._rate(params)
        sigma = self._vols(params)[None, :]
        dt = t2 - t1
        if scheme == SimulationScheme.ANALYTICAL:
            return torch.log(next_state / state) - (rate - 0.5 * sigma * sigma) * dt
        if scheme != SimulationScheme.EULER:
            raise NotImplementedError(f"BlackScholesMulti does not invert {scheme.name}")
        return (next_state / state - 1.0 - rate * dt) / (sigma * math.sqrt(dt))

    def kernel_block(self, scheme, param_base=0):
        if scheme not in (SimulationScheme.ANALYTICAL, SimulationScheme.EULER):
            return None
        n = self.num_assets
        return KernelBlock("bs_multi",
                           "exact" if scheme == SimulationScheme.ANALYTICAL else "euler",
                           param_base, n, n)

    def kernel_correlation(self):
        return self._corr

    def resolve_obs(self, params, kind, asset_id, t1, t2, state):
        # black_scholes_multi.py:136-148
        rate = self._rate(params)
        if kind == AtomicRequestType.SPOT:
            return self._col(state, self.asset_ids.index(asset_id))
        if kind == AtomicRequestType.DISCOUNT_FACTOR:
            return torch.exp(-rate * (t1 - self.calibration_date))
        if kind == AtomicRequestType.FORWARD_RATE:
            return torch.exp(rate * (t2 - t1))
        if kind == AtomicRequestType.LIBOR_RATE:
            return (torch.exp(rate * (t2 - t1)) - 1.0) / (t2 - t1)
        if kind == AtomicRequestType.NUMERAIRE:
            return torch.exp(rate * (t1 - self.calibration_date))
        raise NotImplementedError(f"Request type {kind} not supported by BlackScholesMulti.")
