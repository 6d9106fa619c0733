"""FlexiCall: a strip of European options with k <= n exercise rights.

Counterpart of ``montecarlo_risk_engine_tpu/products/flexicall.py``: states =
remaining rights + 1; the per-date rule compares ``immediate +
continuation(state - 1) > continuation(state)`` (flexicall.py:109-111), so
exercising keeps the game alive in the decremented state.  The JAX package
checks its arguments with bare ``assert``s (flexicall.py:34-45), which
``python -O`` strips; the port raises ``ValueError``.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from montecarlo_risk_engine_tpu_torch.products.base import OptionType, Product, ProductFamily
from montecarlo_risk_engine_tpu_torch.products.european_option import EuropeanOption
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequest, AtomicRequestType


class FlexiCall(Product):
    def __init__(self, underlyings: List[EuropeanOption], num_exercise_rights: int,
                 asset_id: Optional[str] = None, itm_only_regression: bool = False):
        super().__init__(asset_ids=[asset_id], product_family=ProductFamily.FLEXICALL_EXERCISE)
        if num_exercise_rights > len(underlyings):
            raise ValueError("Number of exercise rights cannot exceed number of underlyings")
        if not all(opt.option_type == underlyings[0].option_type for opt in underlyings):
            raise ValueError("All underlyings must have the same option type")
        self.underlyings = sorted(underlyings, key=lambda opt: opt.exercise_date)
        if not all(a.exercise_date < b.exercise_date
                   for a, b in zip(self.underlyings, self.underlyings[1:])):
            raise ValueError("Exercise dates must be distinct")

        self.num_exercise_rights = int(num_exercise_rights)
        self.itm_only_regression = bool(itm_only_regression)
        self.product_timeline = tuple(opt.exercise_date for opt in self.underlyings)
        self.modeling_timeline = self.product_timeline
        self.regression_timeline = self.product_timeline

        asset = self.get_asset_id()
        self.numeraire_requests = {idx: AtomicRequest(AtomicRequestType.NUMERAIRE, t)
                                   for idx, t in enumerate(self.modeling_timeline)}
        self.spot_requests = {(idx, asset): AtomicRequest(AtomicRequestType.SPOT)
                              for idx in range(len(self.modeling_timeline))}
        self.underlying_requests = {idx: opt.underlying_requests[0]
                                    for idx, opt in enumerate(self.underlyings)}

    def get_num_states(self):
        return self.num_exercise_rights + 1

    def get_initial_state(self):
        return self.num_exercise_rights

    @property
    def _sign(self) -> float:
        return 1.0 if self.underlyings[0].option_type == OptionType.CALL else -1.0

    def _decide(self, immediate, hold, exercised, state_matrix, state_after, numeraire_col):
        should_exercise = (immediate + exercised > hold) & (state_matrix > 0)
        cashflows = immediate * should_exercise.to(immediate.dtype) / numeraire_col
        return torch.where(should_exercise, state_after, state_matrix), cashflows

    def compute_normalized_cashflows(self, time_idx, model, params, resolved_requests,
                                     regression_function=None, state_matrix=None):
        if regression_function is None or state_matrix is None:
            raise ValueError("Discrete exercise evaluation requires a regression function and "
                             "state matrix.")
        underlying = resolved_requests[1][self.underlying_requests[time_idx].get_handle()]
        explanatory = resolved_requests[0][self.spot_requests[(time_idx, self.get_asset_id())].handle]
        numeraire = resolved_requests[0][self.numeraire_requests[time_idx].handle]

        strike = self.underlyings[time_idx].strike
        immediate = torch.clamp(self._sign * (underlying - strike), min=0.0)[:, None]
        immediate = immediate.expand(state_matrix.shape)
        state_after = torch.where(state_matrix > 0, state_matrix - 1, state_matrix)
        if time_idx == len(self.product_timeline) - 1 or self.regression_coeffs is None:
            hold = exercised = torch.zeros_like(immediate)
        else:
            grid = lambda s: self.compute_continuation_values(
                explanatory=explanatory, regression_function=regression_function,
                state_matrix=s, coeffs_all_states=self.regression_coeffs[time_idx])
            hold, exercised = grid(state_matrix), grid(state_after)
        numeraire_col = numeraire[:, None] if numeraire.dim() == 1 else numeraire
        return self._decide(immediate, hold, exercised, state_matrix, state_after, numeraire_col)

    # -- the controller's event scan (flexicall.py:119-152) ----------------------

    def scan_event_strikes(self):
        return [opt.strike for opt in self.underlyings]

    def scan_regression_weights(self, underlying_value, strike):
        if not self.itm_only_regression:
            return None
        return (self._sign * (underlying_value - strike[:, None]) > 0.0).to(underlying_value.dtype)

    def scan_bucket_statics(self):
        return (self.underlyings[0].option_type, self.itm_only_regression)

    def scan_exercise_step(self, regression_function, state_matrix, underlying_value,
                           explanatory, numeraire, strike, coeffs):
        """One decision of a bucket: states [P, N, S], underlying,
        explanatory and numeraire [P, N], strike [P], coeffs [P, S, deg]."""
        immediate = torch.clamp(self._sign * (underlying_value - strike[:, None]), min=0.0)
        immediate = immediate[..., None].expand(state_matrix.shape)
        state_after = torch.where(state_matrix > 0, state_matrix - 1, state_matrix)
        grid = self.evaluate_regression_grid(explanatory, regression_function, coeffs)
        hold = self.lookup_state_values(grid, state_matrix)
        exercised = self.lookup_state_values(grid, state_after)
        return self._decide(immediate, hold, exercised, state_matrix, state_after,
                            numeraire[..., None])
