"""Bermudan / American option by Longstaff-Schwartz.

Counterpart of ``montecarlo_risk_engine_tpu/products/bermudan_option.py``: a
two-state exercise machine (one right), the per-date decision ``immediate >
continuation and rights > 0`` with a state decrement on exercise
(bermudan_option.py:80-116), optionally only in the money
(``itm_only_regression``, which also weights the LSM fit by the
in-the-money mask).

The exercise decision stays a hard comparison: gradients flow through the
payoff along the chosen branch, never through the policy
(bermudan_option.py:8-11).

Two steps with one decision rule: ``compute_normalized_cashflows`` (the
per-date unrolled path, [N, S] states, coefficients from
``regression_coeffs``) and ``scan_exercise_step`` (the controller's event
scan over a bucket of products, [P, N, S] states, per-event inputs passed
in).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch.products.base import OptionType, Product, ProductFamily
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequest, AtomicRequestType


class BermudanOption(Product):
    def __init__(self, underlying: Product, exercise_dates: Sequence[float], strike: float,
                 option_type: OptionType, asset_id: Optional[str] = None,
                 itm_only_regression: bool = False):
        super().__init__(asset_ids=[asset_id], product_family=ProductFamily.BERMUDAN_EXERCISE)
        self.strike = float(strike)
        self.option_type = option_type
        self.num_exercise_rights = 1
        self.itm_only_regression = bool(itm_only_regression)
        self.product_timeline = tuple(float(t) for t in exercise_dates)
        self.modeling_timeline = self.product_timeline
        self.regression_timeline = self.product_timeline

        self.numeraire_requests = {idx: AtomicRequest(AtomicRequestType.NUMERAIRE, t)
                                   for idx, t in enumerate(self.modeling_timeline)}
        asset = self.asset_ids[0]
        self.spot_requests = {(idx, asset): AtomicRequest(AtomicRequestType.SPOT)
                              for idx in range(len(self.modeling_timeline))}
        self.underlying_requests = {idx: underlying.generate_underlying_requests_for_date(t)
                                    for idx, t in enumerate(self.product_timeline)}

    def get_num_states(self):
        return 2

    def get_initial_state(self):
        return 1

    @property
    def _sign(self) -> float:
        return 1.0 if self.option_type == OptionType.CALL else -1.0

    def _decide(self, immediate, continuation, state_matrix, numeraire_col):
        """(next states, deflated cashflows) of one exercise decision."""
        should_exercise = (immediate > continuation) & (state_matrix > 0)
        if self.itm_only_regression:
            # standard LSM: exercise only in the money, else a negative
            # extrapolated continuation burns the right for a zero payoff
            should_exercise = should_exercise & (immediate > 0.0)
        state_after = torch.where(state_matrix > 0, state_matrix - 1, state_matrix)
        cashflows = immediate * should_exercise.to(immediate.dtype) / numeraire_col
        return torch.where(should_exercise, state_after, state_matrix), cashflows

    def compute_normalized_cashflows(self, time_idx, model, params, resolved_requests,
                                     regression_function=None, state_matrix=None):
        if regression_function is None or state_matrix is None:
            raise ValueError("Discrete exercise evaluation requires a regression function and "
                             "state matrix.")
        underlying = resolved_requests[1][self.underlying_requests[time_idx].get_handle()]
        explanatory = resolved_requests[0][self.spot_requests[(time_idx, self.asset_ids[0])].handle]
        numeraire = resolved_requests[0][self.numeraire_requests[time_idx].handle]

        immediate = torch.clamp(self._sign * (underlying - self.strike), min=0.0)[:, None]
        immediate = immediate.expand(state_matrix.shape)
        if time_idx == len(self.product_timeline) - 1 or self.regression_coeffs is None:
            continuation = torch.zeros_like(immediate)
        else:
            continuation = self.compute_continuation_values(
                explanatory=explanatory, regression_function=regression_function,
                state_matrix=state_matrix, coeffs_all_states=self.regression_coeffs[time_idx])
        numeraire_col = numeraire[:, None] if numeraire.dim() == 1 else numeraire
        return self._decide(immediate, continuation, state_matrix, numeraire_col)

    # -- the controller's event scan (bermudan_option.py:120-160) ----------------

    def scan_event_strikes(self):
        """Per-product-date scalar fed to scan_exercise_step (the strike)."""
        return [self.strike] * len(self.product_timeline)

    def scan_regression_weights(self, underlying_value, strike):
        """In-the-money mask [P, N] as LSM fit weights, or None for the
        reference's all-path fit; strike [P]."""
        if not self.itm_only_regression:
            return None
        return (self._sign * (underlying_value - strike[:, None]) > 0.0).to(underlying_value.dtype)

    def scan_bucket_statics(self):
        return (self.option_type, self.itm_only_regression)

    def scan_exercise_step(self, regression_function, state_matrix, underlying_value,
                           explanatory, numeraire, strike, coeffs):
        """One decision of a bucket of products: states [P, N, S], underlying,
        explanatory and numeraire [P, N], strike [P], coeffs [P, S, deg].  At
        a product's last date the continuation is zero because the backward
        scan fits those coefficients on zero targets."""
        immediate = torch.clamp(self._sign * (underlying_value - strike[:, None]), min=0.0)
        immediate = immediate[..., None].expand(state_matrix.shape)
        continuation = self.compute_continuation_values(
            explanatory=explanatory, regression_function=regression_function,
            state_matrix=state_matrix, coeffs_all_states=coeffs)
        return self._decide(immediate, continuation, state_matrix, numeraire[..., None])


class AmericanOption(BermudanOption):
    """American option on a uniform exercise grid from 0 to maturity
    (bermudan_option.py:163-187)."""

    def __init__(self, underlying: Product, maturity: float, num_exercise_dates: int,
                 strike: float, option_type: OptionType, asset_id: Optional[str] = None):
        exercise_dates = (np.linspace(0.0, maturity, num_exercise_dates)
                          if num_exercise_dates > 1 else [maturity])
        super().__init__(underlying=underlying, exercise_dates=exercise_dates, strike=strike,
                         option_type=option_type, asset_id=asset_id)
