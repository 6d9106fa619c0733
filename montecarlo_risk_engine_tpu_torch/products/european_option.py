"""European option on a generic underlying.

Counterpart of ``montecarlo_risk_engine_tpu/products/european_option.py``:
terminal payoff on a composite underlying value, the Black-Scholes closed
form, and the Heston characteristic-function pricer (a host-side numpy/scipy
oracle).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy.integrate import quad

from montecarlo_risk_engine_tpu_torch.models.heston import HestonModel
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
