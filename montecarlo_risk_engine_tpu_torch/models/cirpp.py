"""CIR++ shifted square-root default-intensity model.

Counterpart of ``montecarlo_risk_engine_tpu/models/cirpp.py``.  Intensity
lambda(t) = y(t) + psi(t); y follows dy = kappa (theta - y) dt + sigma
sqrt(y) dW, and psi(t) = lambda_market(t) + D(t) - y0 E(t) fits the market
survival curve (D = d/dt ln A(0,t), E = d/dt B(0,t), cirpp.py:108-125).

State = [y, log_B]: log_B accumulates the pathwise integral of lambda (left
Riemann), so SURVIVAL_PROBABILITY resolves to exp(-log_B) and
CONDITIONAL_SURVIVAL_PROBABILITY to the closed form S(t, T | y_t).  Params
(reference order): kappa, theta, sigma, y0.  Market hazards are static
configuration.  The full-truncation Euler step and its inversion, the
Milstein step, the analytical step (a moment-matched lognormal proxy of the
CIR transition) with its Gaussian factor loading, and the deterministic
mode (``deterministic=True``: y tracks the market hazard, cirpp.py:134-149)
are ported.  Alone under EULER the model takes K2 as one "cirpp" or
"cirpp_det" block (cirpp.py:151-187); the other schemes run on the engine.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict

import torch

from montecarlo_risk_engine_tpu_torch.config import SimulationScheme
from montecarlo_risk_engine_tpu_torch.helpers.cs_helper import probability_of_default
from montecarlo_risk_engine_tpu_torch.models.base import Model, like, per_row
from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import KernelBlock
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequestType

_EPS = 1e-12


class CIRPPModel(Model):
    kernel_schemes = (SimulationScheme.EULER,)

    def __init__(self, calibration_date: float, asset_id: str, hazard_rates: Dict[float, float],
                 kappa: float, theta: float, volatility: float, y0: float,
                 deterministic: bool = False):
        super().__init__(calibration_date=calibration_date, state_dim=2, asset_ids=[asset_id])
        if not (2.0 * kappa * theta - volatility ** 2 > 0.0 and y0 > 0.0):
            raise ValueError("Feller condition not met.")
        self._init = (float(kappa), float(theta), float(volatility), float(y0))
        self.tenors = tuple(float(t) for t in hazard_rates.keys())
        self.hazard_rates = tuple(float(h) for h in hazard_rates.values())
        self.deterministic = bool(deterministic)

    def _initial_values(self):
        return self._init

    def get_model_param_names(self):
        return ["kappa", "theta", "sigma", "y0"]

    # -- market curve -------------------------------------------------------

    def lambda_market(self, t: float) -> float:
        """Piecewise-constant market hazard at a static time, flat beyond the
        last tenor: the first tenor >= t (the reference's searchsorted,
        side='left', cirpp.py:77-82)."""
        idx = min(bisect_left(self.tenors, float(t)), len(self.tenors) - 1)
        return self.hazard_rates[idx]

    def _market_survival(self, t, ref: torch.Tensor) -> torch.Tensor:
        return 1.0 - probability_of_default(like(self.hazard_rates, ref),
                                            like(self.tenors, ref), like(t, ref))

    # -- CIR closed forms (cirpp.py:89-125) ---------------------------------

    @staticmethod
    def _h(params):
        kappa, _, sigma, _ = params
        return torch.sqrt(kappa * kappa + 2.0 * sigma * sigma)

    def _A(self, params, t, T):
        kappa, theta, sigma, _ = params
        h = self._h(params)
        dt = like(T, h) - like(t, h)
        num = 2.0 * h * torch.exp(0.5 * (kappa + h) * dt)
        den = 2.0 * h + (kappa + h) * (torch.exp(h * dt) - 1.0)
        return (num / den) ** (2.0 * kappa * theta / (sigma * sigma))

    def _B(self, params, t, T):
        kappa, _, sigma, _ = params
        h = self._h(params)
        dt = like(T, h) - like(t, h)
        e = torch.exp(h * dt) - 1.0
        return 2.0 * e / (2.0 * h + (kappa + h) * e)

    def _D(self, params, t):
        kappa, theta, sigma, _ = params
        h = self._h(params)
        et = torch.exp(h * t)
        inner = 0.5 * (kappa + h) - (h * (kappa + h) * et) / (2.0 * h + (kappa + h) * (et - 1.0))
        return (2.0 * kappa * theta / (sigma * sigma)) * inner

    def _E(self, params, t):
        kappa, _, sigma, _ = params
        h = self._h(params)
        et = torch.exp(h * t)
        return 4.0 * h * h * et / (2.0 * h + (kappa + h) * (et - 1.0)) ** 2

    def _lambda_market_of(self, t, ref: torch.Tensor):
        """:meth:`lambda_market` at a static time or, elementwise, at a
        tensor of times (JAX cirpp.py:77-82's searchsorted)."""
        if not torch.is_tensor(t):
            return self.lambda_market(t)
        idx = torch.searchsorted(like(self.tenors, ref), t.to(ref.dtype), side="left")
        return like(self.hazard_rates, ref)[idx.clamp(max=len(self.tenors) - 1)]

    def psi(self, params, t):
        """The shift psi(t) at a static time or a tensor of times."""
        return (self._lambda_market_of(t, params[3]) + self._D(params, t)
                - params[3] * self._E(params, t))

    def lambda_t(self, params, t, y_t):
        """The intensity y_t + psi(t); y_t itself in the deterministic mode
        (JAX cirpp.py:127-130)."""
        if self.deterministic:
            return y_t
        return y_t + self.psi(params, t)

    # -- simulation ---------------------------------------------------------

    def init_state(self, params, num_paths):
        y = params[3].expand(num_paths)
        if self.deterministic:  # the market hazard at the calibration date
            y = like(self.lambda_market(self.calibration_date), params[3]).expand(num_paths)
        return torch.stack([y, torch.zeros_like(y)], dim=-1)

    def _step_deterministic(self, t1, t2, state):
        # Track the market hazard exactly (cirpp.py:142-149).
        log_b = state[:, 1] + self.lambda_market(t1) * (t2 - t1)
        y = torch.full_like(state[:, 0], self.lambda_market(t2))
        return torch.stack([y, log_b], dim=-1)

    def step_euler(self, params, t1, t2, state, corr_noise):
        # Full-truncation Euler with the lambda accumulator (cirpp.py:206-218).
        if self.deterministic:
            return self._step_deterministic(t1, t2, state)
        dt = t2 - t1
        y = state[:, 0]
        kappa, theta, sigma, _ = params
        noise = corr_noise[:, 0]
        sqrt_y = torch.sqrt(torch.clamp(y, min=0.0))
        y_next = y + kappa * (theta - y) * dt + sigma * sqrt_y * math.sqrt(dt) * noise
        log_b = state[:, 1] + (y + self.psi(params, t1)) * dt
        return torch.stack([torch.clamp(y_next, min=1e-12), log_b], dim=-1)

    def step_milstein(self, params, t1, t2, state, corr_noise):
        # Euler plus the Milstein term of the sqrt(y) diffusion, 0.25 sigma^2
        # (dW^2 - dt), as Heston's variance leg (cirpp.py:220-240).
        if self.deterministic:
            return self._step_deterministic(t1, t2, state)
        dt = t2 - t1
        y = state[:, 0]
        kappa, theta, sigma, _ = params
        dw = math.sqrt(dt) * corr_noise[:, 0]
        sqrt_y = torch.sqrt(torch.clamp(y, min=0.0))
        y_next = (y + kappa * (theta - y) * dt + sigma * sqrt_y * dw
                  + 0.25 * sigma * sigma * (dw * dw - dt))
        log_b = state[:, 1] + (y + self.psi(params, t1)) * dt
        return torch.stack([torch.clamp(y_next, min=1e-12), log_b], dim=-1)

    def step_analytical(self, params, t1, t2, state, corr_noise):
        # A lognormal with the CIR transition's conditional mean and variance
        # (cirpp.py:242-265).  The ANALYTICAL noise carries the std of
        # covariance_matrix, which is divided out to recover the standard
        # normal driver.
        if self.deterministic:
            return self._step_deterministic(t1, t2, state)
        dt = t2 - t1
        y = state[:, 0]
        kappa, theta, sigma, _ = params
        ekt = torch.exp(-kappa * dt)
        m = theta + (y - theta) * ekt
        v = sigma * sigma * (y * ekt * (1.0 - ekt) / kappa + 0.5 * theta * (1.0 - ekt) ** 2 / kappa)
        var_ratio = torch.clamp(v / (m * m + _EPS), min=1e-12)
        mu_ln = torch.log(torch.clamp(m, min=_EPS)) - 0.5 * torch.log1p(var_ratio)
        sig_ln = torch.sqrt(torch.log1p(var_ratio))
        std = torch.sqrt(self.covariance_matrix(params, dt)[0, 0])
        z = corr_noise[:, 0] / torch.clamp(std, min=_EPS)
        y_next = torch.exp(mu_ln + sig_ln * z)
        log_b = state[:, 1] + (y + self.psi(params, t1)) * dt
        return torch.stack([torch.clamp(y_next, min=1e-12), log_b], dim=-1)

    def analytic_factor_loadings(self, params):
        """At the representative level y = theta the CIR diffusion is an OU
        factor of mean reversion kappa and vol sigma sqrt(theta), whose
        increment variance is :meth:`covariance_matrix` (cirpp.py:267-285):
        a ModelConfig's ANALYTICAL covariance correlates this model's driver
        with the other Gaussian factors at the configured rho."""
        kappa, theta, sigma, _ = params
        return [(kappa, sigma * torch.sqrt(theta))]

    def covariance_matrix(self, params, delta_t):
        # The conditional CIR variance at y = theta (cirpp.py:287-292): only
        # the scale of the ANALYTICAL noise, divided out by the step.
        kappa, theta, sigma, _ = params
        ekt = torch.exp(-kappa * delta_t)
        v = sigma * sigma * theta * (ekt * (1.0 - ekt) / kappa + 0.5 * (1.0 - ekt) ** 2 / kappa)
        return torch.clamp(v, min=_EPS).reshape(1, 1)

    def invert_noise(self, params, scheme, t1, t2, state, next_state):
        # Euler residual of y (cirpp.py:189-204).  Where the diffusion
        # vanishes (y <= 0 under full truncation) the draw is unrecoverable
        # and its tangent coefficient is 0, so it is returned as 0.
        #
        # A step that landed on the 1e-12 floor has lost its draw too: every
        # pre-floor value at or below the floor gives the same state.  The
        # residual of the floor value itself would put the reconstruction's
        # pre-floor value on the kink, within rounding of the floor, where
        # the max takes the tangent of the unfloored branch on some paths
        # (the JAX package's inversion does this, and its recovered tangents
        # then differ from direct AD).  So the noise returned there puts the
        # pre-floor value at -(|y| + |drift|), below the floor by the size of
        # the step's own terms: a reconstruction from states that carry the
        # float32 kernel's rounding (~1e-8 relative) still takes the floor,
        # whose tangent, 0, is the pathwise derivative.
        if scheme != SimulationScheme.EULER:
            raise NotImplementedError("CIRPPModel inverts the Euler step only")
        if self.deterministic:  # consumes no noise (cirpp.py:195-196)
            return torch.zeros_like(state[:, 0:1])
        kappa, theta, sigma, _ = params
        dt = t2 - t1
        y, y_next = state[:, 0:1], next_state[:, 0:1]
        diff = sigma * torch.sqrt(torch.clamp(y, min=0.0)) * math.sqrt(dt)
        drift = kappa * (theta - y) * dt
        target = torch.where(y_next <= 1e-12, -(y.abs() + drift.abs()), y_next)
        raw = target - y - drift
        live = diff > 0.0
        return torch.where(live, raw / torch.where(live, diff, torch.ones_like(diff)),
                           torch.zeros_like(raw))

    # -- survival quantities (cirpp.py:296-311) -----------------------------

    def kernel_block(self, scheme, param_base=0):
        if scheme != SimulationScheme.EULER:
            return None
        return KernelBlock("cirpp_det" if self.deterministic else "cirpp", "euler", param_base,
                           2, 1, hazard_tenors=self.tenors, hazard_rates=self.hazard_rates)

    def survival_probability(self, params, t, T, y_t):
        """S(t, T | y_t); ``t``/``T`` floats or [n] tensors against y_t [n, N]."""
        y0 = params[3]
        if self.deterministic:  # the market curve's ratio (cirpp.py:297-299)
            ratio = self._market_survival(T, y0) / self._market_survival(t, y0)
            return torch.ones_like(y_t) * per_row(ratio, y_t)
        a0t, a0T = self._A(params, 0.0, t), self._A(params, 0.0, T)
        b0t, b0T = self._B(params, 0.0, t), self._B(params, 0.0, T)
        sm_t, sm_T = self._market_survival(t, y0), self._market_survival(T, y0)
        a_tT, b_tT = self._A(params, t, T), self._B(params, t, T)
        pref = (sm_T / sm_t) * (a0t / a0T) * torch.exp(-b0t * y0 + b0T * y0)
        return per_row(pref * a_tT, y_t) * torch.exp(-per_row(b_tT, y_t) * y_t)

    def credit_spread(self, params, t, T, y_t, delta: float = 0.40):
        """The par spread -ln(delta + (1 - delta) S(t, T | y_t)) / (T - t)
        of a claim recovering ``delta`` (JAX cirpp.py:313-317)."""
        s = self.survival_probability(params, t, T, y_t)
        dt = torch.clamp(like(T, s) - like(t, s), min=1e-12)
        inside = torch.clamp(delta + (1.0 - delta) * s, min=1e-24)
        return -torch.log(inside) / per_row(dt, s)

    def resolve_obs(self, params, kind, asset_id, t1, t2, state):
        if kind == AtomicRequestType.SURVIVAL_PROBABILITY:
            return torch.exp(-self._col(state, 1))
        if kind == AtomicRequestType.CONDITIONAL_SURVIVAL_PROBABILITY:
            return self.survival_probability(params, t1, t2, self._col(state, 0))
        raise NotImplementedError(f"Request type {kind} not supported by CIRPPModel.")
