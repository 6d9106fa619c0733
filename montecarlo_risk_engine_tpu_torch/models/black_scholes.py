"""Single-asset Black-Scholes (GBM) model.

Counterpart of ``montecarlo_risk_engine_tpu/models/black_scholes.py``.
State = [S]; params (reference order): spot, volatility, rate.  This slice
ports the Euler step (the scheme of the hybrid books) and its inversion;
the exact log-normal step comes with the standalone BS kernel route.
"""

from __future__ import annotations

import math

import torch

from montecarlo_risk_engine_tpu_torch.config import SimulationScheme
from montecarlo_risk_engine_tpu_torch.models.base import Model
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequestType


class BlackScholesModel(Model):
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

    def step_euler(self, params, t1, t2, state, corr_noise):
        # S' = S + r S dt + sigma S sqrt(dt) z (black_scholes.py:109).
        _, sigma, rate = params
        dt = t2 - t1
        return state + rate * state * dt + sigma * state * math.sqrt(dt) * corr_noise

    def invert_noise(self, params, scheme, t1, t2, state, next_state):
        if scheme != SimulationScheme.EULER:
            raise NotImplementedError("BlackScholesModel inverts the Euler step only")
        _, sigma, rate = params
        dt = t2 - t1
        return (next_state / state - 1.0 - rate * dt) / (sigma * math.sqrt(dt))

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
