"""Basket option (arithmetic / geometric) with an optional control variate.

Counterpart of ``montecarlo_risk_engine_tpu/products/basket_option.py``: a
weighted basket's terminal payoff; the control-variate mode prices the
arithmetic payoff minus the geometric payoff plus the closed-form geometric
PV (basket_option.py:68-74).  The closed form under BlackScholesMulti keeps
the reference's quirks: ``f_bar`` is the unweighted geometric mean of all
the model's spots and the drift correction uses ``sum(sigma^2) / n``
(basket_option.py:88-110), so it prices an equal-weight basket of every
asset of the model.
"""

from __future__ import annotations

import enum
from typing import Sequence

import torch

from montecarlo_risk_engine_tpu_torch.products.base import OptionType, Product, ProductFamily
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequest, AtomicRequestType


class BasketOptionType(enum.Enum):
    ARITHMETIC = 0
    GEOMETRIC = 1


class BasketOption(Product):
    def __init__(self, maturity: float, asset_ids: Sequence[str], weights: Sequence[float],
                 strike: float, option_type: OptionType,
                 basket_option_type: BasketOptionType = BasketOptionType.ARITHMETIC,
                 use_variation_reduction: bool = False):
        super().__init__(asset_ids=asset_ids, product_family=ProductFamily.BASKET_TERMINAL_PAYOFF)
        self.maturity = float(maturity)
        self.strike = float(strike)
        self.weights = tuple(float(w) for w in weights)
        self.option_type = option_type
        self.basket_option_type = basket_option_type
        self.use_variation_reduction = use_variation_reduction
        self.product_timeline = (self.maturity,)
        self.modeling_timeline = self.product_timeline
        self.regression_timeline = ()

        self.numeraire_requests = {0: AtomicRequest(AtomicRequestType.NUMERAIRE, maturity)}
        self.spot_requests = {(0, asset_id): AtomicRequest(AtomicRequestType.SPOT)
                              for asset_id in self.asset_ids}

    def _basket(self, spots, basket_type: BasketOptionType):
        w = torch.as_tensor(self.weights, dtype=spots.dtype, device=spots.device)
        if basket_type == BasketOptionType.ARITHMETIC:
            return torch.sum(spots * w, dim=1)
        return torch.exp(torch.sum(torch.log(spots + 1e-10) * w, dim=1))

    def _vanilla_payoff(self, basket):
        sign = 1.0 if self.option_type == OptionType.CALL else -1.0
        return torch.clamp(sign * (basket - self.strike), min=0.0)

    def payoff(self, spots, model, params):
        base = self._vanilla_payoff(self._basket(spots, self.basket_option_type))
        if not self.use_variation_reduction:
            return base
        geometric = self._vanilla_payoff(self._basket(spots, BasketOptionType.GEOMETRIC))
        return base - geometric + self.compute_pv_analytically(model, params)

    def compute_normalized_cashflows(self, time_idx, model, params, resolved_requests,
                                     regression_function=None, state_matrix=None):
        spots = torch.stack([resolved_requests[0][self.spot_requests[(0, a)].handle]
                             for a in self.asset_ids], dim=1)
        numeraire = resolved_requests[0][self.numeraire_requests[0].handle]
        normalized = self.payoff(spots, model, params) / numeraire
        return state_matrix, normalized[:, None]

    def compute_pv_analytically(self, model, params):
        """Closed-form geometric basket under BlackScholesMulti
        (basket_option.py:88-110)."""
        n = model.num_assets
        spots = torch.stack(params[:n])
        sigmas = torch.stack(params[n:2 * n])
        rate = params[2 * n]
        tau = self.maturity
        w = torch.as_tensor(self.weights, dtype=spots.dtype, device=spots.device)

        f_bar = torch.exp(torch.mean(torch.log(spots)))
        basket_var = w @ model.covariance_matrix(params, tau) @ w
        sigma_b = torch.sqrt(basket_var)
        sum_sq = torch.sum(sigmas ** 2)
        fwd = f_bar * torch.exp((rate - 0.5 * sum_sq / n) * tau + 0.5 * sigma_b ** 2)

        d1 = (torch.log(fwd / self.strike) + 0.5 * sigma_b ** 2) / sigma_b  # cov carries tau
        d2 = d1 - sigma_b
        disc = torch.exp(-rate * tau)
        ndtr = torch.special.ndtr
        if self.option_type == OptionType.CALL:
            return disc * (fwd * ndtr(d1) - self.strike * ndtr(d2))
        return disc * (self.strike * ndtr(-d2) - fwd * ndtr(-d1))
