"""Plain-vanilla interest-rate swap: floating leg minus fixed leg.

Counterpart of ``montecarlo_risk_engine_tpu/products/swap.py``: two Bond
legs without notional exchange, a merged modeling timeline, and per-date
cashflows from whichever leg pays on that date.
"""

from __future__ import annotations

import enum
from collections import defaultdict

from montecarlo_risk_engine_tpu_torch.products.base import Product
from montecarlo_risk_engine_tpu_torch.products.bond import Bond
from montecarlo_risk_engine_tpu_torch.requests import UnderlyingRequest


class IRSType(enum.Enum):
    PAYER = 0
    RECEIVER = 1


class InterestRateSwap(Product):
    def __init__(self, startdate: float, enddate: float, notional: float, fixed_rate: float,
                 tenor_fixed: float, tenor_float: float, irs_type: IRSType,
                 asset_id: str | None = None):
        super().__init__(asset_ids=[asset_id])
        self.startdate = float(startdate)
        self.enddate = float(enddate)
        self.notional = float(notional)
        self.fixed_rate = float(fixed_rate)
        self.tenor_fixed = float(tenor_fixed)
        self.tenor_float = float(tenor_float)
        self.irs_type = irs_type
        self.composite_req_handle = None

        self.fixed_leg = Bond(startdate=startdate, maturity=enddate, notional=notional,
                              tenor=tenor_fixed, pays_notional=False, fixed_rate=fixed_rate,
                              asset_id=asset_id)
        self.floating_leg = Bond(startdate=startdate, maturity=enddate, notional=notional,
                                 tenor=tenor_float, pays_notional=False, fixed_rate=None,
                                 asset_id=asset_id)
        self.product_timeline = tuple(sorted(set(self.fixed_leg.modeling_timeline)
                                             | set(self.floating_leg.modeling_timeline)))
        self.modeling_timeline = self.product_timeline
        self.regression_timeline = ()

    def _key(self):
        return ("IRS", self.startdate, self.enddate, self.notional, self.fixed_rate,
                self.tenor_fixed, self.tenor_float, self.get_asset_id())

    def __eq__(self, other):
        return isinstance(other, InterestRateSwap) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    # -- requests: union of both legs (swap.py:83-99) ---------------------------

    def get_atomic_requests(self):
        requests = defaultdict(list)
        for leg in (self.fixed_leg, self.floating_leg):
            for (local_t, asset), reqs in leg.get_atomic_requests().items():
                # leg-local time index -> index on the merged timeline
                merged_t = self.modeling_timeline.index(leg.modeling_timeline[local_t])
                requests[(merged_t, asset)].extend(reqs)
        return requests

    def get_atomic_requests_for_underlying(self):
        requests = defaultdict(list)
        for leg in (self.fixed_leg, self.floating_leg):
            for label, reqs in leg.get_atomic_requests_for_underlying().items():
                requests[label].extend(reqs)
        return requests

    def generate_underlying_requests_for_date(self, observation_date):
        return UnderlyingRequest(InterestRateSwap(
            startdate=float(observation_date), enddate=self.enddate, notional=self.notional,
            fixed_rate=self.fixed_rate, tenor_fixed=self.tenor_fixed,
            tenor_float=self.tenor_float, irs_type=self.irs_type, asset_id=self.get_asset_id()))

    def get_value(self, resolved_atomic_requests):
        fixed_value = self.fixed_leg.get_value(resolved_atomic_requests)
        float_value = self.floating_leg.get_value(resolved_atomic_requests)
        if self.irs_type == IRSType.PAYER:
            return float_value - fixed_value
        return fixed_value - float_value

    def compute_normalized_cashflows(self, time_idx, model, params, resolved_requests,
                                     regression_function=None, state_matrix=None):
        time = self.modeling_timeline[time_idx]
        legs = []
        for leg in (self.fixed_leg, self.floating_leg):
            cf = 0.0
            if time in leg.modeling_timeline:
                _, cf = leg.compute_normalized_cashflows(
                    leg.modeling_timeline.index(time), model, params, resolved_requests,
                    regression_function, state_matrix)
            legs.append(cf)
        fixed_cf, float_cf = legs
        total = float_cf - fixed_cf if self.irs_type == IRSType.PAYER else fixed_cf - float_cf
        return state_matrix, total
