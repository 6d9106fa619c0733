"""Product base class: timelines, request declaration, valuation hooks.

Counterpart of ``montecarlo_risk_engine_tpu/products/base.py`` (request
bookkeeping and the valuation protocol; the LSM continuation-value helpers
come with the exercise products).

  * ``compute_normalized_cashflows`` returns cashflows already divided by the
    pathwise numeraire, so everything is discounted to t = 0.
  * ``product_timeline`` (cashflow events), ``modeling_timeline``
    (observation dates) and ``regression_timeline`` (LSM dates; empty for
    European-style products) are static float tuples.
  * ``params`` (model parameters) is threaded through every valuation method
    so autograd reaches them.
"""

from __future__ import annotations

import enum
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from montecarlo_risk_engine_tpu_torch.requests import (
    AtomicRequest,
    AtomicRequestType,
    UnderlyingRequest,
)


class OptionType(enum.Enum):
    CALL = 1
    PUT = 2


class ProductFamily(enum.Enum):
    GENERIC = "generic"
    VANILLA_TERMINAL_OPTION = "vanilla_terminal_option"
    BINARY_TERMINAL_PAYOFF = "binary_terminal_payoff"
    BASKET_TERMINAL_PAYOFF = "basket_terminal_payoff"
    ASIAN_PATH_TERMINAL = "asian_path_terminal"
    BARRIER_PATH_TERMINAL = "barrier_path_terminal"
    BERMUDAN_EXERCISE = "bermudan_exercise"
    FLEXICALL_EXERCISE = "flexicall_exercise"
    STORAGE_EXERCISE = "storage_exercise"


class Product:
    def __init__(
        self,
        asset_ids: Optional[Sequence[str]] = None,
        product_id: int = 0,
        product_family: ProductFamily = ProductFamily.GENERIC,
    ):
        self.asset_ids = list(asset_ids) if asset_ids else [""]
        self.product_id = product_id
        self.name: Optional[str] = None
        self.product_family = product_family

        self.spot_requests: Dict[Tuple[int, str], AtomicRequest] = {}
        self.numeraire_requests: Dict[int, AtomicRequest] = {}
        self.libor_requests: Dict[Tuple[int, str], AtomicRequest] = {}
        self.underlying_requests: Dict[int, UnderlyingRequest] = {}

        self.product_timeline: Tuple[float, ...] = ()
        self.modeling_timeline: Tuple[float, ...] = ()
        self.regression_timeline: Tuple[float, ...] = ()

    # -- request declaration (product.py:59-88) -----------------------------

    def get_atomic_requests(self) -> Dict[Tuple[int, str], List[AtomicRequest]]:
        requests: Dict[Tuple[int, str], List[AtomicRequest]] = defaultdict(list)
        for t, req in self.numeraire_requests.items():
            requests[(t, "numeraire")].append(req)
        for label, req in self.spot_requests.items():
            requests[label].append(req)
        for label, req in self.libor_requests.items():
            requests[label].append(req)
        return requests

    def get_atomic_requests_for_underlying(self) -> Dict[Tuple[int, str], List[AtomicRequest]]:
        return defaultdict(list)

    def generate_underlying_requests_for_date(self, observation_date: float) -> UnderlyingRequest:
        raise NotImplementedError

    def get_underlying_requests(self) -> Dict[int, List[UnderlyingRequest]]:
        requests: Dict[int, List[UnderlyingRequest]] = defaultdict(list)
        for t, req in self.underlying_requests.items():
            requests[t].append(req)
        return requests

    # -- state machine (product.py:90-155) -----------------------------------

    def get_num_states(self) -> int:
        return 1

    def get_initial_state(self):
        return 0

    def state_is_continuous(self) -> bool:
        return False

    def get_asset_id(self, idx: Optional[int] = None) -> str:
        return self.asset_ids[idx] if idx else self.asset_ids[0]

    def get_name(self) -> str:
        return self.name if self.name else type(self).__name__

    def get_product_family(self) -> ProductFamily:
        return self.product_family

    # -- resolved-request access (product.py:105-135) --------------------------

    def get_resolved_atomic_request(
        self, resolved_atomic_requests, request_type: AtomicRequestType,
        time_idx: int, asset_id: Optional[str] = None,
    ):
        if request_type == AtomicRequestType.NUMERAIRE:
            return resolved_atomic_requests[self.numeraire_requests[time_idx].handle]
        if request_type == AtomicRequestType.SPOT:
            return resolved_atomic_requests[self.spot_requests[(time_idx, asset_id)].handle]
        if request_type in (AtomicRequestType.LIBOR_RATE, AtomicRequestType.FORWARD_RATE):
            return resolved_atomic_requests[self.libor_requests[(time_idx, asset_id)].handle]
        raise KeyError(request_type)

    # -- valuation hooks --------------------------------------------------------

    def compute_normalized_cashflows(
        self, time_idx: int, model, params, resolved_requests,
        regression_function=None, state_matrix=None,
    ):
        """Per product-date step: returns (next_state_matrix, cashflows[N, S]),
        cashflows already numeraire-deflated (product.py:190-198)."""
        raise NotImplementedError

    # -- analytic hooks (product.py:200-217) --------------------------------------

    def compute_pv_analytically(self, model, params):
        raise NotImplementedError

    def supports_analytic_pv(self, model) -> bool:
        return False

    def supports_analytic_exposure(self, model) -> bool:
        return False
