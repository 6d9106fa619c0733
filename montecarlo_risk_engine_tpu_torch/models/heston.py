"""Heston stochastic-volatility model: full-truncation Euler + Andersen QE.

Counterpart of ``montecarlo_risk_engine_tpu/models/heston.py``.
State = [logS, v]; simulation_dim = 2.  Params (reference order): spot,
volatility (vol-of-vol), rate, rho, kappa, theta, initial_variance.

QE follows Andersen (2008) with gamma1=1, gamma2=0 K-coefficients and the
reference's fuzzy choices: the mass-at-zero indicator of the exp-mixture
branch is smoothed with width 0.3 and the psi-switch at psi_c = 1.5 with
width 0.5, both gated on ``perform_smoothing``.  Under QE the driver noise is
uncorrelated; the spot/variance correlation enters through the K
coefficients.
"""

from __future__ import annotations

import torch

from montecarlo_risk_engine_tpu_torch.config import SimulationScheme
from montecarlo_risk_engine_tpu_torch.models.base import Model
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequestType
from montecarlo_risk_engine_tpu_torch.utils.maths import compute_degree_of_truth

_EPS = 1e-12


class HestonModel(Model):
    def __init__(
        self,
        calibration_date: float,
        spot: float,
        rate: float,
        sigma: float,
        rho: float,
        kappa: float,
        theta: float,
        v0: float,
        asset_id: str | None = None,
        martingale_correction: bool = False,
    ):
        super().__init__(
            calibration_date=calibration_date,
            asset_ids=[asset_id] if asset_id else None,
            simulation_dim=2,
            state_dim=2,
        )
        self._init = (float(spot), float(sigma), float(rate), float(rho),
                      float(kappa), float(theta), float(v0))
        # Andersen's martingale correction (eq. 44): replaces K0 with the
        # branch-dependent K0* so E[S_{t+dt}] = S_t e^{r dt} at any step.
        # Off by default, as in the reference.  The path kernel does not
        # implement it, so a corrected model runs on the engine only.
        self.martingale_correction = bool(martingale_correction)

    def _initial_values(self):
        return self._init

    def get_model_param_names(self):
        return ["spot", "volatility", "rate", "rho", "kappa", "theta", "initial_variance"]

    @staticmethod
    def _unpack(params):
        spot, sigma, rate, rho, kappa, theta, v0 = params
        return spot, sigma, rate, rho, kappa, theta, v0

    def init_state(self, params, num_paths):
        spot, *_, v0 = self._unpack(params)
        log_s = torch.log(spot).expand(num_paths)
        v = v0.expand(num_paths)
        return torch.stack([log_s, v], dim=-1)

    def correlation_matrix(self, params, scheme):
        if scheme == SimulationScheme.QE:
            return super().correlation_matrix(params, scheme)
        rho = params[3]
        one = torch.ones_like(rho)
        return torch.stack([torch.stack([one, rho]), torch.stack([rho, one])])

    def uses_uniforms(self, scheme):
        return scheme == SimulationScheme.QE

    # -- path kernel --------------------------------------------------------

    def supports_kernel_paths(self, scheme):
        # The kernel mirrors both branch modes (hard forward-only, fuzzy
        # 0.3/0.5 when perform_smoothing) but has no eq.-44 branch.
        return scheme == SimulationScheme.QE and not self.martingale_correction

    def _check_kernel(self, scheme):
        if not self.supports_kernel_paths(scheme):
            raise ValueError(
                "the Heston QE path kernel needs scheme QE without the "
                "martingale correction (it has no eq.-44 branch)"
            )

    def kernel_paths(self, params, scheme, timeline, num_paths, num_steps,
                     seed, phase=0):
        """QE trajectory via ops/heston_qe.heston_qe_paths; [T, N, 2] f32."""
        from montecarlo_risk_engine_tpu_torch.ops.heston_qe import heston_qe_paths

        self._check_kernel(scheme)
        return heston_qe_paths(
            params, timeline, num_paths, num_steps, seed=seed, phase=phase,
            calibration_date=self.calibration_date,
            smoothing=self.perform_smoothing,
        )

    def kernel_paths_with_noise(self, params, scheme, timeline, num_paths,
                                seed, phase=0):
        """(states [T, N, 2], z [T, N, 2], u [T, N]) f32 at a substep-dense
        timeline, for the emitted-noise AD path (ops/paths_ad.py)."""
        from montecarlo_risk_engine_tpu_torch.ops.heston_qe import heston_qe_paths

        self._check_kernel(scheme)
        return heston_qe_paths(
            params, timeline, num_paths, 1, seed=seed, phase=phase,
            calibration_date=self.calibration_date,
            smoothing=self.perform_smoothing, emit_noise=True,
        )

    # -- steps --------------------------------------------------------------

    def step_euler(self, params, t1, t2, state, corr_noise):
        # Full-truncation Euler (heston.py:99-121).
        _, sigma, rate, _, kappa, theta, _ = self._unpack(params)
        dt = t2 - t1
        log_s, v = state[:, 0], state[:, 1]
        sqrt_v = torch.sqrt(torch.clamp(v, min=0.0))
        sqrt_dt = dt ** 0.5
        log_s_next = log_s + (rate - 0.5 * v) * dt + sqrt_v * sqrt_dt * corr_noise[:, 0]
        v_next = v + kappa * (theta - v) * dt + sigma * sqrt_v * sqrt_dt * corr_noise[:, 1]
        return torch.stack([log_s_next, torch.clamp(v_next, min=0.0)], dim=-1)

    def _cir_conditional_moments(self, params, v, dt):
        # E[v_{t+dt}|v_t] and Var[v_{t+dt}|v_t] (heston.py:123-143).
        _, sigma, _, _, kappa, theta, _ = self._unpack(params)
        ekt = torch.exp(-kappa * dt)
        mean = theta + (v - theta) * ekt
        var = (
            v * sigma * sigma * ekt * (1.0 - ekt) / kappa
            + theta * sigma * sigma * (1.0 - ekt) ** 2 / (2.0 * kappa)
        )
        return mean, var

    def _qe_k_coefficients(self, params, dt):
        # Andersen eq. 33 with gamma1=1, gamma2=0 (heston.py:145-159).
        _, sigma, _, rho, kappa, theta, _ = self._unpack(params)
        gamma1, gamma2 = 1.0, 0.0
        k0 = -rho * kappa * theta / sigma * dt
        k1 = (kappa * rho / sigma - 0.5) * gamma1 * dt - rho / sigma
        k2 = (kappa * rho / sigma - 0.5) * gamma2 * dt + rho / sigma
        k3 = (1.0 - rho * rho) * gamma1 * dt
        k4 = (1.0 - rho * rho) * gamma2 * dt
        return k0, k1, k2, k3, k4

    def step_qe(self, params, t1, t2, state, corr_noise, uniform):
        _, sigma, rate, rho, kappa, theta, _ = self._unpack(params)
        dt = t2 - t1
        log_s, v = state[:, 0], state[:, 1]
        z_s, z_v = corr_noise[:, 0], corr_noise[:, 1]
        u = uniform[:, 0] if uniform.dim() == 2 else uniform

        m, s2 = self._cir_conditional_moments(params, v, dt)
        psi = s2 / (m * m + _EPS)

        # Quadratic branch (psi <= 2): v1 = a (b + z)^2 (heston.py:161-189).
        inv_psi = 1.0 / (psi + _EPS)
        tail = torch.clamp(2.0 * inv_psi - 1.0, min=0.0)
        b2 = torch.clamp(2.0 * inv_psi - 1.0 + torch.sqrt(2.0 * inv_psi) * torch.sqrt(tail), min=0.0)
        a = m / (1.0 + b2)
        v_quad = a * (torch.sqrt(b2) + z_v) ** 2

        # Exp-mixture branch (psi >= 1) with fuzzy mass-at-zero indicator,
        # width 0.3 (heston.py:192-232).
        p = torch.clamp((psi - 1.0) / (psi + 1.0), 0.0, 1.0 - 1e-6)
        beta = (1.0 - p) / (m + _EPS)
        v_tail = torch.log(torch.clamp(1.0 - p, min=_EPS) / torch.clamp(1.0 - u, min=_EPS)) / (beta + _EPS)
        w_mass = compute_degree_of_truth(u - p, self.perform_smoothing, 0.3)
        v_exp = w_mass * v_tail

        # Fuzzy switch between branches around psi_c = 1.5, width 0.5.
        w = compute_degree_of_truth(psi - 1.5, self.perform_smoothing, 0.5)
        v_next = (1.0 - w) * v_quad + w * v_exp

        k0, k1, k2, k3, k4 = self._qe_k_coefficients(params, dt)
        if self.martingale_correction:
            # Andersen eq. 44 with gamma2 = 0 (K4 = 0): K0* = -ln M - (K1 +
            # 0.5 K3) v where M = E[exp(K2 V+)|v] per branch.
            a_coef = m / (1.0 + b2)
            quad_arg = torch.clamp(k2 * a_coef, max=0.5 - 1e-6)
            m_quad = torch.exp(quad_arg * b2 / (1.0 - 2.0 * quad_arg)) / torch.sqrt(
                torch.clamp(1.0 - 2.0 * quad_arg, min=_EPS)
            )
            beta_safe = torch.maximum(beta, k2 + 1e-8)
            m_exp = p + beta_safe * (1.0 - p) / (beta_safe - k2)
            mart = torch.where(psi > 1.5, m_exp, m_quad)
            k0 = -torch.log(torch.clamp(mart, min=_EPS)) - (k1 + 0.5 * k3) * v
        var_int = torch.clamp(k3 * v + k4 * v_next, min=0.0)
        vol = torch.sqrt(torch.clamp(var_int, min=_EPS))
        log_s_next = log_s + rate * dt + k0 + k1 * v + k2 * v_next + vol * z_s
        return torch.stack([log_s_next, v_next], dim=-1)

    # -- observables ----------------------------------------------------------

    def resolve_obs(self, params, kind, asset_id, t1, t2, state):
        # heston.py:255-280: spot from log-state, constant-rate closed forms.
        _, _, rate, *_ = self._unpack(params)
        if kind == AtomicRequestType.SPOT:
            return torch.exp(state[..., 0])
        if kind == AtomicRequestType.DISCOUNT_FACTOR:
            return torch.exp(-rate * (t1 - self.calibration_date))
        if kind == AtomicRequestType.FORWARD_RATE:
            return torch.exp(rate * (t2 - t1))
        if kind == AtomicRequestType.LIBOR_RATE:
            return (torch.exp(rate * (t2 - t1)) - 1.0) / (t2 - t1)
        if kind == AtomicRequestType.NUMERAIRE:
            return torch.exp(rate * (t1 - self.calibration_date))
        raise NotImplementedError(f"Request type {kind} not supported by HestonModel.")
