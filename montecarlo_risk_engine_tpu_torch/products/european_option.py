"""European option on a generic underlying.

Counterpart of ``montecarlo_risk_engine_tpu/products/european_option.py``:
terminal payoff on a composite underlying value, the Black-Scholes closed
form and the pathwise analytic exposure it gives under a Black-Scholes
model, the closed-form gamma and vomma (the oracles of the Hessian), the
Vasicek zero-bond option and the Heston characteristic-function pricer (a
host-side numpy/scipy oracle).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from scipy.integrate import quad

from montecarlo_risk_engine_tpu_torch.models.black_scholes import BlackScholesModel
from montecarlo_risk_engine_tpu_torch.models.black_scholes_multi import BlackScholesMulti
from montecarlo_risk_engine_tpu_torch.models.heston import HestonModel
from montecarlo_risk_engine_tpu_torch.models.vasicek import VasicekModel
from montecarlo_risk_engine_tpu_torch.products.base import (
    OptionType,
    Product,
    ProductFamily,
)
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequest, AtomicRequestType


class EuropeanOption(Product):
    def __init__(
        self,
        underlying: Product,
        exercise_date: float,
        strike: float,
        option_type: OptionType,
        asset_id: Optional[str] = None,
    ):
        super().__init__(
            asset_ids=[asset_id],
            product_family=ProductFamily.VANILLA_TERMINAL_OPTION,
        )
        self.exercise_date = float(exercise_date)
        self.strike = float(strike)
        self.option_type = option_type
        self.underlying = underlying
        self.product_timeline = (self.exercise_date,)
        self.modeling_timeline = self.product_timeline
        self.regression_timeline = ()

        self.numeraire_requests = {0: AtomicRequest(AtomicRequestType.NUMERAIRE, exercise_date)}
        self.underlying_requests = {0: underlying.generate_underlying_requests_for_date(exercise_date)}

    # -- payoff (european_option.py:45-68) -----------------------------------

    def payoff(self, underlying_values, model, params):
        sign = 1.0 if self.option_type == OptionType.CALL else -1.0
        return torch.clamp(sign * (underlying_values - self.strike), min=0.0)

    def compute_normalized_cashflows(
        self, time_idx, model, params, resolved_requests,
        regression_function=None, state_matrix=None,
    ):
        value = resolved_requests[1][self.underlying_requests[0].get_handle()]
        numeraire = resolved_requests[0][self.numeraire_requests[0].handle]
        normalized = self.payoff(value, model, params) / numeraire
        return state_matrix, normalized[:, None]

    # -- Black-Scholes closed form (european_option.py:70-100) ----------------

    def bs_price(self, spot, rate, sigma, tau):
        """Black-Scholes price of this option: tensors spot, rate, sigma;
        ``tau`` a float or tensor."""
        sqrt_tau = torch.sqrt(torch.as_tensor(tau, dtype=spot.dtype, device=spot.device))
        d1 = (torch.log(spot / self.strike) + (rate + 0.5 * sigma * sigma) * tau) / (sigma * sqrt_tau)
        d2 = d1 - sigma * sqrt_tau
        disc_k = self.strike * torch.exp(-rate * tau)
        ndtr = torch.special.ndtr
        if self.option_type == OptionType.CALL:
            return spot * ndtr(d1) - disc_k * ndtr(d2)
        return disc_k * ndtr(-d2) - spot * ndtr(-d1)

    def _bs_spot_vol_rate(self, model, params):
        """(spot, sigma, rate) of this option's asset (european_option.py:75-80)."""
        if isinstance(model, BlackScholesMulti):
            idx = model.asset_ids.index(self.get_asset_id())
            return params[idx], params[model.num_assets + idx], params[2 * model.num_assets]
        return params[0], params[1], params[2]

    def supports_analytic_pv(self, model) -> bool:
        return isinstance(model, (BlackScholesModel, BlackScholesMulti))

    def supports_analytic_exposure(self, model) -> bool:
        return isinstance(model, (BlackScholesModel, BlackScholesMulti))

    def compute_pv_analytically(self, model, params):
        """Black-Scholes price at the calibration date (european_option.py:97-100)."""
        spot, sigma, rate = self._bs_spot_vol_rate(model, params)
        return self.bs_price(spot, rate, sigma, self.exercise_date - model.calibration_date)

    def compute_discounted_exposure_analytically(self, exposure_time, spot, numeraire, model,
                                                 params):
        """Discounted Black-Scholes value on each path (european_option.py:102-110)."""
        tau = self.exercise_date - float(exposure_time)
        spot = torch.reshape(spot, (-1,))
        if tau <= 0.0:
            return torch.zeros_like(spot)
        _, sigma, rate = self._bs_spot_vol_rate(model, params)
        return self.bs_price(spot, rate, sigma, tau) / torch.reshape(numeraire, (-1,))

    # -- second-order closed forms (european_option.py:114-128) --------------------
    # Black-Scholes gamma and vomma of params (spot, volatility, rate), over
    # tau = exercise date, as the JAX package (and the reference) takes it.

    def _bs_d1(self, params):
        spot, sigma, rate = params[0], params[1], params[2]
        tau = self.exercise_date
        return (torch.log(spot / self.strike) + (rate + 0.5 * sigma * sigma) * tau) / (
            sigma * math.sqrt(tau))

    def compute_dDeltadSpot_analytically(self, model, params):
        """Black-Scholes gamma, d^2 PV / d spot^2."""
        spot, sigma = params[0], params[1]
        d1 = self._bs_d1(params)
        pdf_d1 = torch.exp(-0.5 * d1 * d1) / math.sqrt(2.0 * math.pi)
        return pdf_d1 / (spot * sigma * math.sqrt(self.exercise_date))

    def compute_dVegadSigma_analytically(self, model, params):
        """Black-Scholes vomma, d^2 PV / d volatility^2."""
        spot, sigma = params[0], params[1]
        d1 = self._bs_d1(params)
        d2 = d1 - sigma * math.sqrt(self.exercise_date)
        pdf_d1 = torch.exp(-0.5 * d1 * d1) / math.sqrt(2.0 * math.pi)
        return spot * pdf_d1 * math.sqrt(self.exercise_date) * d1 * d2 / sigma

    # -- Vasicek zero-bond option (european_option.py:175-190) -------------------

    def compute_pv_bond_option_analytically(self, model: VasicekModel, params):
        """Option on the zero bond underlying it under Vasicek (Jamshidian):
        the Black form on P(t0, T_bond) against K P(t0, T_exercise) with the
        bond's price volatility."""
        from montecarlo_risk_engine_tpu_torch.products.bond import Bond

        if not isinstance(self.underlying, Bond):
            raise TypeError("Expected the underlying to be a Bond")
        rate, sigma, _, a = params
        t0 = model.calibration_date
        p_exercise = model.bond_price(params, t0, self.exercise_date, rate)
        p_maturity = model.bond_price(params, t0, self.underlying.maturity, rate)
        b_ts = (1.0 - torch.exp(-a * (self.underlying.maturity - self.exercise_date))) / a
        sigma_p = sigma * torch.sqrt(
            (1.0 - torch.exp(-2.0 * a * (self.exercise_date - t0))) / (2.0 * a)) * b_ts
        d1 = (torch.log(p_maturity / (p_exercise * self.strike)) + 0.5 * sigma_p ** 2) / sigma_p
        d2 = d1 - sigma_p
        ndtr = torch.special.ndtr
        if self.option_type == OptionType.CALL:
            return p_maturity * ndtr(d1) - self.strike * p_exercise * ndtr(d2)
        return self.strike * p_exercise * ndtr(-d2) - p_maturity * ndtr(-d1)

    # -- Heston semi-analytic price (host-side oracle) ----------------------------
    # Stable characteristic-function form (european_option.py:156-262): the
    # branch with Re(d) <= 0 and exp(-dT) in the log terms.

    @staticmethod
    def _heston_cf(idx, u, T, s0, r, kappa, theta, sigma, rho, v0):
        i = 1j
        a = kappa * theta
        if idx == 1:
            b, u_shift = kappa - rho * sigma, 0.5
        else:
            b, u_shift = kappa, -0.5
        z = (rho * sigma * i * u - b) ** 2 + sigma**2 * (u**2 - 2.0 * i * u * u_shift)
        d = np.sqrt(z)
        if np.real(d) > 0:
            d = -d
        g = (b - rho * sigma * i * u - d) / (b - rho * sigma * i * u + d)
        exp_neg = np.exp(-d * T)
        C = r * i * u * T + (a / sigma**2) * (
            (b - rho * sigma * i * u - d) * T - 2.0 * np.log((1.0 - g * exp_neg) / (1.0 - g))
        )
        D = ((b - rho * sigma * i * u - d) / sigma**2) * ((1.0 - exp_neg) / (1.0 - g * exp_neg))
        return np.exp(C + D * v0 + i * u * np.log(s0))

    def heston_call_price(self, model: HestonModel, strike: float, maturity: float, params=None):
        params = params if params is not None else model.initial_params()
        s0, sigma, r, rho, kappa, theta, v0 = (float(p) for p in params)

        def q_j(j):
            def integrand(u_real):
                u = u_real + 0j
                phi = self._heston_cf(j, u, maturity, s0, r, kappa, theta, sigma, rho, v0)
                return np.real(np.exp(-1j * u * np.log(strike)) * phi / (1j * u))

            integral, _ = quad(integrand, 0.0, 100.0, limit=200)
            return 0.5 + integral / np.pi

        return s0 * q_j(1) - strike * np.exp(-r * maturity) * q_j(2)

    def compute_pv_analytically_heston(self, model: HestonModel, params=None):
        if not isinstance(model, HestonModel):
            raise TypeError("Expected a HestonModel")
        return self.heston_call_price(model, self.strike, self.exercise_date, params)
