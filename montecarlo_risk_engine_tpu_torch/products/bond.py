"""Bond: zero-coupon, fixed-coupon or floating-rate note.

Counterpart of ``montecarlo_risk_engine_tpu/products/bond.py``:
``fixed_rate=None`` selects floating coupons; the schedule walks
``startdate + k * tenor`` up to maturity; as a composite underlying the
value is the sum of discounted coupons (+ notional), the floating leg
telescoping to ``notional * (DF_{k-1} - DF_k)``.  FORWARD_RATE requests
resolve to conditional bond prices P(t_obs, t_pay) (vasicek.py:161-165).
Per-date fixed coupons carry the ``notional`` factor (the JAX package's
deliberate deviation Q5 from the reference).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional

import torch

from montecarlo_risk_engine_tpu_torch.products.base import Product
from montecarlo_risk_engine_tpu_torch.requests import (
    AtomicRequest,
    AtomicRequestType,
    UnderlyingRequest,
)


class Bond(Product):
    def __init__(self, startdate: float, maturity: float, notional: float, tenor: float,
                 pays_notional: bool = True, fixed_rate: Optional[float] = None,
                 asset_id: str | None = None):
        super().__init__(asset_ids=[asset_id])
        self.startdate = float(startdate)
        self.maturity = float(maturity)
        self.notional = float(notional)
        self.tenor = float(tenor)
        self.fixed_rate = None if fixed_rate is None else float(fixed_rate)
        self.pays_notional = bool(pays_notional)
        self.composite_req_handle = None

        asset = self.get_asset_id()
        self.atomic_requests_for_underlying = {}
        payment_dates = []
        # The schedule (bond.py:59-99): coupons at start + tenor, ..., then a
        # final payment at maturity.
        date = self.startdate + self.tenor
        idx = 0
        fwd = lambda t1, t2: AtomicRequest(AtomicRequestType.FORWARD_RATE, t1, t2)
        if self.fixed_rate is not None:
            while date < self.maturity - 1e-12:
                self.numeraire_requests[idx] = AtomicRequest(AtomicRequestType.NUMERAIRE, date)
                self.atomic_requests_for_underlying[(idx, asset)] = fwd(self.startdate, date)
                payment_dates.append(date)
                date += self.tenor
                idx += 1
            self.numeraire_requests[idx] = AtomicRequest(AtomicRequestType.NUMERAIRE, self.maturity)
            self.atomic_requests_for_underlying[(idx, asset)] = fwd(self.startdate, self.maturity)
            payment_dates.append(self.maturity)
        else:
            while date < self.maturity - 1e-12:
                self.libor_requests[(idx, asset)] = AtomicRequest(
                    AtomicRequestType.LIBOR_RATE, date - self.tenor, date)
                self.numeraire_requests[idx] = AtomicRequest(AtomicRequestType.NUMERAIRE, date)
                self.atomic_requests_for_underlying[(idx, asset)] = fwd(
                    self.startdate, date - self.tenor)
                payment_dates.append(date)
                date += self.tenor
                idx += 1
            self.libor_requests[(idx, asset)] = AtomicRequest(
                AtomicRequestType.LIBOR_RATE, date - self.tenor, self.maturity)
            self.numeraire_requests[idx] = AtomicRequest(AtomicRequestType.NUMERAIRE, self.maturity)
            self.atomic_requests_for_underlying[(idx, asset)] = fwd(self.startdate, date - self.tenor)
            self.atomic_requests_for_underlying[(idx + 1, asset)] = fwd(self.startdate, self.maturity)
            payment_dates.append(self.maturity)

        self.payment_dates = tuple(payment_dates)
        self.product_timeline = self.payment_dates
        self.modeling_timeline = self.payment_dates
        self.regression_timeline = ()

    def _key(self):
        return ("Bond", self.startdate, self.maturity, self.tenor, self.fixed_rate,
                self.pays_notional, self.notional, self.get_asset_id())

    def __eq__(self, other):
        return isinstance(other, Bond) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    # -- as composite underlying (bond.py:126-173) ------------------------------

    def get_atomic_requests_for_underlying(self):
        requests = defaultdict(list)
        for label, req in self.atomic_requests_for_underlying.items():
            requests[label].append(req)
        return requests

    def generate_underlying_requests_for_date(self, observation_date):
        return UnderlyingRequest(Bond(
            startdate=float(observation_date), maturity=self.maturity, notional=self.notional,
            tenor=self.tenor, pays_notional=self.pays_notional, fixed_rate=self.fixed_rate,
            asset_id=self.get_asset_id()))

    def get_value(self, resolved_atomic_requests):
        asset = self.get_asset_id()
        df_of = lambda idx: resolved_atomic_requests[
            self.atomic_requests_for_underlying[(idx, asset)].handle]
        total = 0.0
        if self.fixed_rate is not None:
            prev_time = self.startdate
            for idx in self.numeraire_requests:
                dt = self.modeling_timeline[idx] - prev_time
                total = total + self.notional * self.fixed_rate * dt * df_of(idx)
                prev_time = self.modeling_timeline[idx]
        else:
            for idx in self.numeraire_requests:
                total = total + self.notional * (df_of(idx) - df_of(idx + 1))
        if self.pays_notional:
            total = total + self.notional * df_of(len(self.modeling_timeline) - 1)
        return total

    # -- per-date cashflows (bond.py:177-199) -------------------------------------

    def compute_normalized_cashflows(self, time_idx, model, params, resolved_requests,
                                     regression_function=None, state_matrix=None):
        numeraire = resolved_requests[0][self.numeraire_requests[time_idx].handle]
        prev_time = self.startdate if time_idx == 0 else self.payment_dates[time_idx - 1]
        dt = self.payment_dates[time_idx] - prev_time
        if self.fixed_rate is not None:
            cashflow = self.notional * self.fixed_rate * dt
        else:
            libor = self.get_resolved_atomic_request(
                resolved_requests[0], AtomicRequestType.LIBOR_RATE, time_idx, self.get_asset_id())
            cashflow = self.notional * libor * dt
        if self.pays_notional and time_idx == len(self.modeling_timeline) - 1:
            cashflow = cashflow + self.notional
        # 0-d for a deterministic numeraire and coupon, else [N].
        return state_matrix, torch.atleast_1d(cashflow / numeraire)[:, None]
