"""Netting set: netted valuation with thresholds and MPoR collateral.

Counterpart of ``montecarlo_risk_engine_tpu/products/netting_set.py``:

  * a symmetric threshold band maps |e| <= threshold to zero;
  * the collateral balance is the threshold-adjusted netted exposure seen
    at ``t - MPoR``: a static gather when the controller gives the delayed
    indices, else interpolation on the exposure grid ('linear' or
    'previous');
  * unsecured exposure = netted exposure - collateral.

Profiles are [T, N] tensors (time-major).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

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
        if self.threshold < 0.0:
            raise ValueError("Netting set threshold must be non-negative.")
        if self.margin_period_of_risk is not None and self.margin_period_of_risk < 0.0:
            raise ValueError("Netting set margin period of risk must be non-negative.")
        if self.collateral_interpolation not in {"linear", "previous"}:
            raise ValueError("Collateral interpolation must be one of {'linear', 'previous'}.")

    def get_name(self) -> str:
        return self.name

    def is_collateralized(self) -> bool:
        return self.margin_period_of_risk is not None

    def get_collateral_query_times(self, exposure_timeline) -> list:
        if not self.is_collateralized():
            return []
        return [t - self.margin_period_of_risk for t in exposure_timeline
                if t - self.margin_period_of_risk >= 0.0]

    def apply_threshold(self, exposures):
        if self.threshold == 0.0:
            return exposures
        thr = self.threshold
        return torch.where(exposures > thr, exposures - thr,
                           torch.where(exposures < -thr, exposures + thr,
                                       torch.zeros_like(exposures)))

    def _interpolate_profiles(self, netted_exposures, exposure_timeline, query_times):
        """[T, N] profiles at query times (netting_set.py:72-92)."""
        timeline = np.asarray(exposure_timeline, dtype=float)
        query = np.asarray(query_times, dtype=float)
        before_start = torch.as_tensor(query < timeline[0], device=netted_exposures.device)[:, None]
        if self.collateral_interpolation == "previous":
            prev_idx = np.clip(np.searchsorted(timeline, query, side="right") - 1, 0,
                               len(timeline) - 1)
            interpolated = netted_exposures[torch.as_tensor(prev_idx)]
        else:
            right = np.clip(np.searchsorted(timeline, query), None, len(timeline) - 1)
            left = np.clip(right - 1, 0, None)
            denom = timeline[right] - timeline[left]
            weights = np.where(denom > 0.0,
                               (query - timeline[left]) / np.where(denom == 0, 1.0, denom), 0.0)
            lo = netted_exposures[torch.as_tensor(left)]
            hi = netted_exposures[torch.as_tensor(right)]
            w = torch.as_tensor(weights, dtype=lo.dtype, device=lo.device)[:, None]
            interpolated = lo + w * (hi - lo)
        return torch.where(before_start, torch.zeros_like(interpolated), interpolated)

    def compute_collateral_profile(self, netted_exposures, exposure_timeline,
                                   metric_exposure_indices=None, delayed_exposure_indices=None):
        if not self.is_collateralized():
            rows = (len(metric_exposure_indices) if metric_exposure_indices is not None
                    else netted_exposures.shape[0])
            return torch.zeros((rows, netted_exposures.shape[1]), dtype=netted_exposures.dtype,
                               device=netted_exposures.device)
        if metric_exposure_indices is not None and delayed_exposure_indices is not None:
            # Static gather: delayed index -1 means "before the first exposure
            # date" -> zero collateral.
            delayed = np.asarray(delayed_exposure_indices)
            valid = torch.as_tensor(delayed >= 0, device=netted_exposures.device)[:, None]
            gathered = self.apply_threshold(netted_exposures[torch.as_tensor(np.clip(delayed, 0, None))])
            return torch.where(valid, gathered, torch.zeros_like(gathered))
        query_times = [t - self.margin_period_of_risk for t in exposure_timeline]
        delayed = self._interpolate_profiles(netted_exposures, exposure_timeline, query_times)
        return self.apply_threshold(delayed)

    def compute_unsecured_exposure_profiles(self, netted_exposures, exposure_timeline,
                                            metric_exposure_indices=None,
                                            delayed_exposure_indices=None):
        if metric_exposure_indices is not None:
            metric_exposures = netted_exposures[torch.as_tensor(np.asarray(metric_exposure_indices))]
        else:
            metric_exposures = netted_exposures
        if not self.is_collateralized():
            return self.apply_threshold(metric_exposures)
        collateral = self.compute_collateral_profile(
            netted_exposures, exposure_timeline, metric_exposure_indices, delayed_exposure_indices)
        return metric_exposures - collateral
