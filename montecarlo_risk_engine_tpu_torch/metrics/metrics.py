"""Risk metrics: PV and the RiskMetrics container.

Counterpart of ``montecarlo_risk_engine_tpu/metrics/metrics.py`` for the PV
slice (exposure metrics and CVA come with the netting/exposure pipeline).
Conventions kept: every metric returns a list of (value, mc_error) pairs,
one per evaluation point; MC error = unbiased std / sqrt(N)
(reference metric.py:26-35).  Sums use ``torch.sum`` — the JAX package's
fixed pairwise order exists for its sharding-determinism contract, which the
port does not carry yet.
"""

from __future__ import annotations

import enum
from typing import Sequence, Tuple

import torch


class MetricType(enum.Enum):
    PV = "Present Value"
    CE = "Current Exposure"
    EPE = "Expected Positive Exposure"
    ENE = "Expected Negative Exposure"
    PFE = "Potential Future Exposure"
    EEPE = "Effective Expected Positive Exposure"
    CVA = "Credit Valuation Adjustment"


class EvaluationType(enum.Enum):
    ANALYTICAL = "Analytical"
    NUMERICAL = "Numerical"


def mc_mean_and_error(values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, unbiased-std / sqrt(N)) over a pathwise vector (metric.py:26-35)."""
    n = values.shape[0]
    mean = values.sum() / n
    if n > 1:
        sigma = torch.sqrt(((values - mean) ** 2).sum() / (n - 1))
    else:
        sigma = torch.zeros_like(mean)
    return mean, sigma / n ** 0.5


class Metric:
    EvaluationType = EvaluationType

    def __init__(self, metric_type: MetricType, evaluation_type: EvaluationType):
        self.metric_type = metric_type
        self.evaluation_type = evaluation_type

    def get_name(self) -> str:
        return self.metric_type.name.lower()

    def evaluate_analytically(self, **kwargs):
        raise NotImplementedError("Analytical evaluation not implemented.")

    def evaluate_numerically(self, **kwargs):
        raise NotImplementedError("Numerical evaluation not implemented.")

    def evaluate(self, **kwargs):
        if self.evaluation_type == EvaluationType.NUMERICAL:
            return self.evaluate_numerically(**kwargs)
        return self.evaluate_analytically(**kwargs)


class PVMetric(Metric):
    def __init__(self, evaluation_type: EvaluationType = EvaluationType.NUMERICAL):
        super().__init__(MetricType.PV, evaluation_type)

    def evaluate_analytically(self, product=None, model=None, params=None, **kwargs):
        if product is None or model is None:
            raise ValueError("Analytical PV evaluation requires both product and model.")
        pv = torch.squeeze(product.compute_pv_analytically(model, params))
        return [(pv, torch.zeros_like(pv))]

    def evaluate_numerically(self, cfs=None, **kwargs):
        return [mc_mean_and_error(cfs)]


class PathwisePrimitive(enum.Enum):
    DISCOUNTED_CASHFLOWS = "discounted_cashflows"
    EXPOSURE_PROFILES = "exposure_profiles"


class RiskMetrics:
    """Metric collection deriving which pathwise primitives are needed
    (risk_metrics.py:14-58)."""

    def __init__(self, metrics: Sequence[Metric], exposure_timeline=None):
        self.metrics = list(metrics)
        self.exposure_timeline = tuple(float(t) for t in (exposure_timeline or []))

        self.any_pv = any(m.metric_type == MetricType.PV for m in self.metrics)
        self.any_exposure = any(m.metric_type != MetricType.PV for m in self.metrics)

        required = []
        if self.any_pv:
            required.append(PathwisePrimitive.DISCOUNTED_CASHFLOWS)
        if self.any_exposure:
            required.append(PathwisePrimitive.EXPOSURE_PROFILES)
        self._required = frozenset(required)
        if self.any_exposure and not self.exposure_timeline:
            raise ValueError(
                "For exposure simulation at least one exposure time point needs to be provided."
            )

    def requires_discounted_cashflows(self) -> bool:
        return PathwisePrimitive.DISCOUNTED_CASHFLOWS in self._required

    def requires_exposure_profiles(self) -> bool:
        return PathwisePrimitive.EXPOSURE_PROFILES in self._required
