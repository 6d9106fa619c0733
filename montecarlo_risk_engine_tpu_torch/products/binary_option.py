"""Binary (digital) option.

Counterpart of ``montecarlo_risk_engine_tpu/products/binary_option.py``.  The
payoff indicator is always fuzzy with width eps = 1 (binary_option.py:44-48),
smoothed even when differentiation is off, as the reference does; the
cash-or-nothing Black-Scholes closed form prices it (binary_option.py:64-70).
"""

from __future__ import annotations

from typing import Optional

import torch

from montecarlo_risk_engine_tpu_torch.models.black_scholes import BlackScholesModel
from montecarlo_risk_engine_tpu_torch.products.base import OptionType, Product, ProductFamily
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequest, AtomicRequestType
from montecarlo_risk_engine_tpu_torch.utils.maths import compute_degree_of_truth


class BinaryOption(Product):
    def __init__(self, maturity: float, strike: float, payment_amount: float,
                 option_type: OptionType, asset_id: Optional[str] = None):
        super().__init__(asset_ids=[asset_id], product_family=ProductFamily.BINARY_TERMINAL_PAYOFF)
        self.maturity = float(maturity)
        self.strike = float(strike)
        self.payment_amount = float(payment_amount)
        self.option_type = option_type
        self.product_timeline = (self.maturity,)
        self.modeling_timeline = self.product_timeline
        self.regression_timeline = ()

        self.numeraire_requests = {0: AtomicRequest(AtomicRequestType.NUMERAIRE, maturity)}
        self.spot_requests = {(0, self.get_asset_id()): AtomicRequest(AtomicRequestType.SPOT)}

    def payoff(self, spots, model, params):
        above = compute_degree_of_truth(spots - self.strike, True, 1.0)
        if self.option_type == OptionType.CALL:
            return self.payment_amount * above
        return self.payment_amount * (1.0 - above)

    def compute_normalized_cashflows(self, time_idx, model, params, resolved_requests,
                                     regression_function=None, state_matrix=None):
        spots = resolved_requests[0][self.spot_requests[(0, self.get_asset_id())].handle]
        numeraire = resolved_requests[0][self.numeraire_requests[0].handle]
        normalized = self.payoff(spots, model, params) / numeraire
        return state_matrix, normalized[:, None]

    def supports_analytic_pv(self, model) -> bool:
        return isinstance(model, BlackScholesModel)

    def compute_pv_analytically(self, model, params):
        spot, sigma, rate = params
        tau = torch.as_tensor(self.maturity, dtype=spot.dtype, device=spot.device)
        d2 = (torch.log(spot / self.strike) + (rate - 0.5 * sigma * sigma) * tau) / (
            sigma * torch.sqrt(tau))
        disc = self.payment_amount * torch.exp(-rate * tau)
        ndtr = torch.special.ndtr
        return disc * ndtr(d2) if self.option_type == OptionType.CALL else disc * ndtr(-d2)
