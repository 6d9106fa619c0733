"""Asian option: arithmetic or geometric average over an observation timeline.

Counterpart of ``montecarlo_risk_engine_tpu/products/asian_option.py``: the
modeling timeline is a linspace of observation dates, the one cashflow the
terminal payoff on the average.  As in the JAX package, the payoff is
deflated by the numeraire at maturity (the reference indexes the first
observation's numeraire, asian_option.py:7-12 there), and the geometric
average is exp(mean(log(S + 1e-10))).
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch.products.base import OptionType, Product, ProductFamily
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequest, AtomicRequestType


class AsianAveragingType(enum.Enum):
    ARITHMETIC = 0
    GEOMETRIC = 1


class AsianOption(Product):
    def __init__(self, startdate: float, maturity: float, strike: float,
                 num_observation_timepoints: int, option_type: OptionType,
                 averaging_type: AsianAveragingType = AsianAveragingType.ARITHMETIC,
                 asset_id: Optional[str] = None):
        super().__init__(asset_ids=[asset_id], product_family=ProductFamily.ASIAN_PATH_TERMINAL)
        self.maturity = float(maturity)
        self.strike = float(strike)
        self.option_type = option_type
        self.averaging_type = averaging_type
        self.product_timeline = (self.maturity,)
        self.modeling_timeline = tuple(
            float(t) for t in np.linspace(startdate, maturity, num_observation_timepoints))
        self.regression_timeline = ()

        self.numeraire_requests = {idx: AtomicRequest(AtomicRequestType.NUMERAIRE, t)
                                   for idx, t in enumerate(self.modeling_timeline)}
        asset = self.get_asset_id()
        self.spot_requests = {(idx, asset): AtomicRequest(AtomicRequestType.SPOT)
                              for idx in range(len(self.modeling_timeline))}

    def _average(self, spots):
        if self.averaging_type == AsianAveragingType.GEOMETRIC:
            return torch.exp(torch.mean(torch.log(spots + 1e-10), dim=1))
        return torch.mean(spots, dim=1)

    def payoff(self, spots, model, params):
        sign = 1.0 if self.option_type == OptionType.CALL else -1.0
        return torch.clamp(sign * (self._average(spots) - self.strike), min=0.0)

    def compute_normalized_cashflows(self, time_idx, model, params, resolved_requests,
                                     regression_function=None, state_matrix=None):
        asset = self.get_asset_id()
        monitored = torch.stack([resolved_requests[0][self.spot_requests[(idx, asset)].handle]
                                 for idx in range(len(self.modeling_timeline))], dim=1)
        numeraire = resolved_requests[0][
            self.numeraire_requests[len(self.modeling_timeline) - 1].handle]
        normalized = self.payoff(monitored, model, params) / numeraire
        return state_matrix, normalized[:, None]
