"""Hull-White one-factor short-rate model fitted to an initial discount curve.

Counterpart of ``montecarlo_risk_engine_tpu/models/hull_white.py``.
r(t) = x(t) + alpha(t) with dx = -a x dt + sigma dW, x(0) = 0 and
alpha(t) = f(0, t) + sigma^2 / (2 a^2) (1 - e^{-a (t - t0)})^2, which
reprices the input curve.  State = [r, log_B] with the left-Riemann
numeraire accumulator of Vasicek.  Params: volatility, mean_reversion.  The
market curve (discount factors at pillars) is static configuration:
log P(0, t) is linear between pillars, and f(0, t) is the float64 segment
forward table computed once on the host (hull_white.py:52-66), the one
table K2 reads too, so the recovered noise of the differentiated kernel
route sees exactly the alpha the kernel used.

Exact OU (ANALYTICAL), Euler and Milstein (= Euler) steps on the x-factor;
alone the model takes K2 as one "hw" block under every one of them
(hull_white.py:167-210).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch.config import SimulationScheme
from montecarlo_risk_engine_tpu_torch.models.base import Model, like, per_row
from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import KernelBlock
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequestType
from montecarlo_risk_engine_tpu_torch.utils.maths import interp


class HullWhiteModel(Model):
    kernel_schemes = (SimulationScheme.ANALYTICAL, SimulationScheme.EULER,
                      SimulationScheme.MILSTEIN)

    def __init__(self, calibration_date: float, curve_times: Sequence[float],
                 curve_discount_factors: Sequence[float], volatility: float,
                 mean_reversion: float, asset_id: str | None = None):
        super().__init__(calibration_date=calibration_date, state_dim=2, asset_ids=[asset_id])
        if len(curve_times) != len(curve_discount_factors) or len(curve_times) < 2:
            raise ValueError("Provide >= 2 curve pillars with matching lengths.")
        self.curve_times = np.asarray([float(t) for t in curve_times], dtype=np.float64)
        self.log_dfs = np.log(np.asarray([float(v) for v in curve_discount_factors],
                                         dtype=np.float64))
        # Segment k covers [t_k, t_{k+1}) with f = -dlogP/dt, right-continuous
        # at pillars, the last slope beyond the end.
        self._fwd_segs_host = -np.diff(self.log_dfs) / np.diff(self.curve_times)
        self._init = (float(volatility), float(mean_reversion))

    @classmethod
    def from_flat_rate(cls, calibration_date, rate, volatility, mean_reversion,
                       horizon: float = 100.0, asset_id=None):
        times = [calibration_date, calibration_date + horizon]
        return cls(calibration_date, times, [1.0, math.exp(-rate * horizon)], volatility,
                   mean_reversion, asset_id=asset_id)

    def _initial_values(self):
        return self._init

    def get_model_param_names(self):
        return ["volatility", "mean_reversion"]

    # -- market curve --------------------------------------------------------

    def _log_p0(self, t, ref: torch.Tensor) -> torch.Tensor:
        """log P_mkt(0, t), linear between pillars, the last slope beyond."""
        times, lp = like(self.curve_times, ref), like(self.log_dfs, ref)
        t = like(t, ref)
        slope_last = (lp[-1] - lp[-2]) / (times[-1] - times[-2])
        beyond = lp[-1] + slope_last * (t - times[-1])
        return torch.where(t > times[-1], beyond, interp(t, times, lp))

    def _fwd0(self, t, ref: torch.Tensor) -> torch.Tensor:
        """f(0, t): the segment-forward table at the segment of t
        (hull_white.py:92-103).  The segment is chosen by comparing in
        float32, as K2's table does (``KernelBlock.hw_fwd0``), so the
        engine, the noise recovery and the kernel take the same segment at
        a substep time that lies within float32 rounding of a pillar (such
        as t_prev + k dt summing to just below it)."""
        times = torch.as_tensor(self.curve_times, dtype=torch.float32, device=ref.device)
        t32 = torch.as_tensor(t, device=ref.device).to(torch.float32).contiguous()
        idx = torch.searchsorted(times, t32, right=True) - 1
        idx = torch.clamp(idx, 0, len(self._fwd_segs_host) - 1)
        return like(self._fwd_segs_host, ref)[idx]

    def _alpha(self, params, t):
        sigma, a = params
        dt = like(t, sigma) - self.calibration_date
        return self._fwd0(t, sigma) + (sigma * sigma / (2.0 * a * a)) * (1.0 - torch.exp(-a * dt)) ** 2

    # -- simulation ----------------------------------------------------------

    def init_state(self, params, num_paths):
        r0 = self._fwd0(self.calibration_date, params[0]).expand(num_paths)
        return torch.stack([r0, torch.zeros_like(r0)], dim=-1)

    def covariance_matrix(self, params, delta_t):
        sigma, a = params
        return ((sigma * sigma / (2.0 * a)) * (1.0 - torch.exp(-2.0 * a * delta_t))).reshape(1, 1)

    def analytic_factor_loadings(self, params):
        sigma, a = params
        return [(a, sigma)]

    def step_analytical(self, params, t1, t2, state, corr_noise):
        # Exact OU on x = r - alpha(t); the noise carries the exact std.
        _, a = params
        dt = t2 - t1
        r = state[:, 0:1]
        log_b = state[:, 1:2] + r * dt
        x_next = (r - self._alpha(params, t1)) * torch.exp(-a * dt) + corr_noise
        return torch.cat([x_next + self._alpha(params, t2), log_b], dim=-1)

    def step_euler(self, params, t1, t2, state, corr_noise):
        sigma, a = params
        dt = t2 - t1
        r = state[:, 0:1]
        log_b = state[:, 1:2] + r * dt
        x = r - self._alpha(params, t1)
        x_next = x - a * x * dt + sigma * math.sqrt(dt) * corr_noise
        return torch.cat([x_next + self._alpha(params, t2), log_b], dim=-1)

    step_milstein = step_euler  # the x-factor diffusion is state-independent

    def invert_noise(self, params, scheme, t1, t2, state, next_state):
        # hull_white.py:152-163
        sigma, a = params
        dt = t2 - t1
        x = state[:, 0:1] - self._alpha(params, t1)
        x_next = next_state[:, 0:1] - self._alpha(params, t2)
        if scheme == SimulationScheme.ANALYTICAL:
            return x_next - x * torch.exp(-a * dt)
        return (x_next - x + a * x * dt) / (sigma * math.sqrt(dt))

    def kernel_block(self, scheme, param_base=0):
        if scheme not in self.kernel_schemes:
            return None
        return KernelBlock("hw", "exact" if scheme == SimulationScheme.ANALYTICAL else "euler",
                           param_base, 2, 1,
                           curve_times=tuple(float(t) for t in self.curve_times),
                           curve_vals=tuple(float(f) for f in self._fwd_segs_host))

    # -- observables -----------------------------------------------------------

    def bond_price(self, params, t1, t2, r_state):
        """P(t1, t2 | r(t1) = r_state) by Hull-White reconstitution
        (hull_white.py:214-224); ``t1``/``t2`` floats or [n] tensors against
        r_state [n, N]."""
        sigma, a = params
        t1, t2 = like(t1, sigma), like(t2, sigma)
        b = (1.0 - torch.exp(-a * (t2 - t1))) / a
        log_ratio = self._log_p0(t2, sigma) - self._log_p0(t1, sigma)
        var_term = (sigma * sigma / (4.0 * a)) * b * b * (
            1.0 - torch.exp(-2.0 * a * (t1 - self.calibration_date)))
        x = r_state - per_row(self._alpha(params, t1), r_state)
        return torch.exp(per_row(log_ratio, r_state) - per_row(b, r_state) * x
                         - per_row(var_term, r_state))

    def resolve_obs(self, params, kind, asset_id, t1, t2, state):
        if kind == AtomicRequestType.SPOT:
            return self._col(state, 0)
        if kind == AtomicRequestType.DISCOUNT_FACTOR:
            ref = params[0]
            return torch.exp(self._log_p0(t1, ref) - self._log_p0(self.calibration_date, ref))
        if kind == AtomicRequestType.FORWARD_RATE:
            # The conditional bond price P(t1, t2), which Bond consumes as a
            # discount factor (hull_white.py:232-236).
            return self.bond_price(params, t1, t2, self._col(state, 0))
        if kind == AtomicRequestType.LIBOR_RATE:
            p = self.bond_price(params, t1, t2, self._col(state, 0))
            return (1.0 / p - 1.0) / per_row(like(t2, p) - like(t1, p), p)
        if kind == AtomicRequestType.NUMERAIRE:
            return torch.exp(self._col(state, 1))
        raise NotImplementedError(f"Request type {kind} not supported by HullWhiteModel.")
