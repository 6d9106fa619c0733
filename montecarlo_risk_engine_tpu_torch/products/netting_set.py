"""Netting set (counterpart of ``montecarlo_risk_engine_tpu/products/netting_set.py``).

This slice nets discounted cashflows for PV only.  Thresholds, margin
periods of risk and collateral interpolation come with the exposure
metrics; until then those arguments raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from montecarlo_risk_engine_tpu_torch.products.base import Product


@dataclass
class NettingSet:
    name: str
    products: Sequence[Product]
    threshold: float = 0.0
    margin_period_of_risk: Optional[float] = None
    counterparty_id: Optional[str] = None
    collateral_interpolation: str = "linear"

    def __post_init__(self):
        self.products = list(self.products)
        if len(self.products) == 0:
            raise ValueError("A netting set must contain at least one product.")
        if (self.threshold != 0.0 or self.margin_period_of_risk is not None
                or self.collateral_interpolation != "linear"):
            raise NotImplementedError(
                "netting-set thresholds and collateral (MPoR) are not ported yet"
            )

    def get_name(self) -> str:
        return self.name
