"""Equity leaf underlying (counterpart of ``montecarlo_risk_engine_tpu/products/equity.py``).

A single SPOT request at the wrapper's observation date; as a composite
request its value is the resolved spot.  Hash/eq by asset id so identical
observations dedup to one handle (reference equity.py:15-19).
"""

from __future__ import annotations

from collections import defaultdict

from montecarlo_risk_engine_tpu_torch.products.base import Product
from montecarlo_risk_engine_tpu_torch.requests import (
    AtomicRequest,
    AtomicRequestType,
    UnderlyingRequest,
)


class Equity(Product):
    def __init__(self, asset_id: str | None = None):
        super().__init__(asset_ids=[asset_id])
        self.composite_req_handle = None
        self.spot_requests = {(0, self.get_asset_id()): AtomicRequest(AtomicRequestType.SPOT)}

    def __eq__(self, other):
        return isinstance(other, Equity) and self.get_asset_id() == other.get_asset_id()

    def __hash__(self):
        return hash(("Equity", self.get_asset_id()))

    def get_atomic_requests_for_underlying(self):
        requests = defaultdict(list)
        for label, req in self.spot_requests.items():
            requests[label].append(req)
        return requests

    def generate_underlying_requests_for_date(self, observation_date):
        return UnderlyingRequest(Equity(self.get_asset_id()))

    def get_value(self, resolved_atomic_requests):
        return self.get_resolved_atomic_request(
            resolved_atomic_requests,
            AtomicRequestType.SPOT,
            time_idx=0,
            asset_id=self.get_asset_id(),
        )
