"""Risk metrics: PV, CE, EPE, ENE, EEPE, PFE, CVA and the RiskMetrics container.

Counterpart of ``montecarlo_risk_engine_tpu/metrics/metrics.py``.
Conventions kept: every metric returns a list of (value, mc_error) pairs,
one per evaluation point; MC error = unbiased std / sqrt(N)
(reference metric.py:26-35); PFE is the order statistic
``sorted[ceil(q N) - 1]`` with the density finite-difference error; EEPE the
plain time average of EE (quirk Q6) unless ``effective``; CVA accumulates
``E+(t_k) S(0, t_k) (1 - S(t_k, t_k+1))`` times (1 - recovery).  Path
means reduce by :func:`fixed_tree_sum`, a pairwise-halving sum in a fixed
order (metrics.py:53-112), so the plane pipeline and the streaming metric
pipeline (api/streaming_metrics.py) reduce the same numbers in the same
order.  Every path-axis reduction takes the run's ``sharding``
(parallel/mesh.PathSharding or None): a rank reduces its own paths, and
:func:`fixed_tree_sum` adds the ranks' partials in a fixed tree, so a metric
value has the same bits on any number of ranks (mesh.py says why the cyclic
layout makes that so); PFE's order statistics count and select across the
ranks.
"""

from __future__ import annotations

import enum
import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from montecarlo_risk_engine_tpu_torch.parallel.collectives import gather, sum_over_ranks
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequest, AtomicRequestType


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


def fixed_tree_sum(values: torch.Tensor, dim: int = 0, sharding=None) -> torch.Tensor:
    """Sum over ``dim`` in a fixed pairwise-halving order (JAX metrics.py:
    53-98): pad to a power of two with zeros, then add the upper half onto
    the lower half until one row is left.  Each output element is the same
    sequence of float adds whatever device or library reduction schedule
    would have been picked.  With a ``sharding``, ``dim`` is this rank's
    share of a path axis: its tree sum, then the tree sum of the ranks'
    partials (parallel/collectives.sum_over_ranks), the bits of the sum on
    one rank."""
    return sum_over_ranks(_tree_sum(values, dim), sharding)


def global_count(local: int, sharding) -> int:
    """The run's path count from this rank's."""
    return local if sharding is None else local * sharding.world_size


def sample_error(sum_sq: torch.Tensor, n: int) -> torch.Tensor:
    """unbiased std / sqrt(n) from the summed squared deviations."""
    if n > 1:
        return torch.sqrt(sum_sq / (n - 1)) / n ** 0.5
    return torch.zeros_like(sum_sq)


def _tree_sum(values: torch.Tensor, dim: int) -> torch.Tensor:
    dim = dim % max(values.dim(), 1)
    n = values.shape[dim] if values.dim() else 0
    if n == 0:
        shape = values.shape[:dim] + values.shape[dim + 1:]
        return torch.zeros(shape, dtype=values.dtype, device=values.device)
    if torch.is_grad_enabled() and values.requires_grad:
        return _TreeSum.apply(values, dim)
    return _halvings(values, dim)


def _halvings(values: torch.Tensor, dim: int) -> torch.Tensor:
    n = values.shape[dim]
    p = 1 << (n - 1).bit_length()
    if p != n:  # +0.0 rows at the end of ``dim``
        values = torch.nn.functional.pad(values, (0, 0) * (values.dim() - 1 - dim) + (0, p - n))
    while values.shape[dim] > 1:
        low, high = values.split(values.shape[dim] // 2, dim)
        values = low + high
    return values.select(dim, 0)


class _TreeSum(torch.autograd.Function):
    """The halvings with the derivatives of a sum, for a pass recorded for
    reverse mode: the backward broadcasts the cotangent in one op, where the
    recorded halvings take two a level (d sum / d x_i is 1 in any order, so
    the gradient has the same bits); the forward derivative is the halvings
    of the tangent, as without the Function."""

    generate_vmap_rule = True

    @staticmethod
    def forward(values, dim):
        return _halvings(values, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        values, ctx.dim = inputs
        ctx.shape = values.shape

    @staticmethod
    def backward(ctx, grad):
        return grad.unsqueeze(ctx.dim).expand(ctx.shape), None

    @staticmethod
    def jvp(ctx, values_t, _):
        return _halvings(values_t, ctx.dim)


def mc_mean_and_error(values: torch.Tensor, sharding=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, unbiased-std / sqrt(N)) over a pathwise vector (metric.py:26-35),
    both moments through :func:`fixed_tree_sum` (over every rank's paths
    with a ``sharding``)."""
    n = global_count(values.shape[0], sharding)
    mean = fixed_tree_sum(values, sharding=sharding) / n
    if n > 1:
        return mean, sample_error(fixed_tree_sum((values - mean) ** 2, sharding=sharding), n)
    return mean, torch.zeros_like(mean)


def _per_date(exposures, transform, sharding):
    """[(mean, error)] of ``transform`` of each date's pathwise exposures:
    one reduction of the [N, T] stack, each date's the bits of its own."""
    if not exposures:
        return []
    mean, err = mc_mean_and_error(transform(torch.stack(exposures, dim=-1)), sharding)
    return list(zip(mean.unbind(0), err.unbind(0)))


class Metric:
    EvaluationType = EvaluationType

    def __init__(self, metric_type: MetricType, evaluation_type: EvaluationType):
        self.metric_type = metric_type
        self.evaluation_type = evaluation_type

    def get_name(self) -> str:
        return self.metric_type.name.lower()

    def set_requests(self, exposure_timeline) -> None:
        pass

    def get_requests(self) -> Dict[Tuple[int, str], List[AtomicRequest]]:
        return defaultdict(list)

    def get_counterparty_ids(self) -> Optional[List[str]]:
        return None

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

    def evaluate_numerically(self, cfs=None, sharding=None, **kwargs):
        return [mc_mean_and_error(cfs, sharding)]


class CEMetric(Metric):
    """Current exposure: relu of the first exposure date (quirk Q10)."""

    def __init__(self, evaluation_type: EvaluationType = EvaluationType.NUMERICAL):
        super().__init__(MetricType.CE, evaluation_type)

    def evaluate_numerically(self, exposures=None, sharding=None, **kwargs):
        return [mc_mean_and_error(torch.clamp(exposures[0], min=0.0), sharding)]


class EPEMetric(Metric):
    def __init__(self, evaluation_type: EvaluationType = EvaluationType.NUMERICAL):
        super().__init__(MetricType.EPE, evaluation_type)

    def evaluate_numerically(self, exposures=None, sharding=None, **kwargs):
        return _per_date(exposures, lambda e: torch.clamp(e, min=0.0), sharding)


class ENEMetric(Metric):
    def __init__(self, evaluation_type: EvaluationType = EvaluationType.NUMERICAL):
        super().__init__(MetricType.ENE, evaluation_type)

    def evaluate_numerically(self, exposures=None, sharding=None, **kwargs):
        return _per_date(exposures, lambda e: -torch.clamp(-e, min=0.0), sharding)


class EEPEMetric(Metric):
    """Time average of per-date EE (quirk Q6); ``effective=True`` takes the
    running maximum of EE first (the regulatory variant)."""

    def __init__(self, evaluation_type: EvaluationType = EvaluationType.NUMERICAL,
                 effective: bool = False):
        super().__init__(MetricType.EEPE, evaluation_type)
        self.effective = bool(effective)

    def get_name(self) -> str:
        return "eepe[effective]" if self.effective else "eepe"

    def evaluate_numerically(self, exposures=None, sharding=None, **kwargs):
        n = global_count(exposures[0].shape[0], sharding)
        per_date_ee = fixed_tree_sum(torch.clamp(torch.stack(exposures, dim=-1), min=0.0),
                                     sharding=sharding) / n
        if self.effective:
            per_date_ee = torch.cummax(per_date_ee, dim=0).values
        return [mc_mean_and_error(per_date_ee)]


# Above this many paths PFE takes the bisection order statistic
# (ops/quantile.order_statistics_bisect) instead of a sort: the same value
# (metrics.py:224-232).
PFE_BISECT_THRESHOLD = 131_072


class PFEMetric(Metric):
    """PFE quantile per exposure date (metrics.py:235-336).

    ``pfe_se``: ``"density-fd"`` (default, the reference's density finite
    difference, kept for parity although it is not a consistent estimator)
    or ``"order-statistic"`` (the +-1-sigma binomial bracket)."""

    def __init__(self, quantile: float = 0.95,
                 evaluation_type: EvaluationType = EvaluationType.NUMERICAL,
                 bisect_threshold: Optional[int] = None, pfe_se: str = "density-fd"):
        super().__init__(MetricType.PFE, evaluation_type)
        self.quantile = float(quantile)
        self.bisect_threshold = (PFE_BISECT_THRESHOLD if bisect_threshold is None
                                 else int(bisect_threshold))
        if pfe_se not in ("density-fd", "order-statistic"):
            raise ValueError(f"pfe_se must be 'density-fd' or 'order-statistic', got {pfe_se!r}")
        self.pfe_se = pfe_se

    def get_name(self) -> str:
        return f"pfe[{self.quantile:g}]"

    def _quantile_se(self, below, pfe, above, n: int, q_index: int):
        if q_index == 0 or q_index == n - 1:
            return torch.zeros_like(pfe)
        f_q = torch.clamp((above - below) / 2.0, min=1e-6)
        se = torch.sqrt(self.quantile * (1.0 - self.quantile) / (n * f_q * f_q))
        flat = (below == pfe) & (above == pfe)
        return torch.where(flat, torch.zeros_like(se), se)

    def _bracket_indices(self, n: int):
        m = self.quantile * n
        half = math.sqrt(n * self.quantile * (1.0 - self.quantile))
        k_lo = min(max(int(math.ceil(m - half)) - 1, 0), n - 1)
        k_hi = min(max(int(math.ceil(m + half)) - 1, 0), n - 1)
        return k_lo, k_hi

    def evaluate_numerically(self, exposures=None, sharding=None, **kwargs):
        if len(exposures) == 0:
            return []
        n = global_count(exposures[0].shape[0], sharding)
        q_index = int(math.ceil(self.quantile * n)) - 1
        if self.pfe_se == "order-statistic":
            se_ks = self._bracket_indices(n)
        else:
            se_ks = (max(q_index - 1, 0), min(q_index + 1, n - 1))
        ks = sorted({se_ks[0], q_index, se_ks[1]})
        stacked = torch.stack(exposures)  # [T, N]
        if n > self.bisect_threshold:
            from montecarlo_risk_engine_tpu_torch.ops.quantile import order_statistics_bisect

            stats = order_statistics_bisect(stacked, ks, sharding=sharding)  # [K, T]
        else:
            if sharding is not None:  # every rank's values: [T, R, N / R] -> [T, N]
                stacked = gather(stacked, sharding).transpose(0, 1).reshape(len(exposures), n)
            sorted_vals = torch.sort(stacked, dim=-1).values
            stats = sorted_vals[:, ks].mT  # [K, T]
        lo, pfe, hi = (stats[ks.index(k)] for k in (se_ks[0], q_index, se_ks[1]))
        if self.pfe_se == "order-statistic":
            se = (hi - lo) / 2.0
        else:
            se = self._quantile_se(lo, pfe, hi, n, q_index)
        return [(pfe[i], se[i]) for i in range(len(exposures))]


class CVAMetric(Metric):
    def __init__(self, counterparty_id: str, recovery_rate: float,
                 evaluation_type: EvaluationType = EvaluationType.NUMERICAL):
        super().__init__(MetricType.CVA, evaluation_type)
        self.counterparty_id = counterparty_id
        self.recovery_rate = float(recovery_rate)
        self.survival_prob_requests: Dict[Tuple[int, str], AtomicRequest] = {}
        self.cond_survival_prob_requests: Dict[Tuple[int, str], AtomicRequest] = {}

    def get_counterparty_ids(self):
        return [self.counterparty_id]

    def get_name(self) -> str:
        return f"cva[{self.counterparty_id}]"

    def set_requests(self, exposure_timeline) -> None:
        # One (unconditional, conditional) survival pair per exposure interval
        # (cva_metric.py:23-44); integer keys index the exposure timeline.
        cp = self.counterparty_id
        for idx in range(len(exposure_timeline) - 1):
            self.cond_survival_prob_requests[(idx, cp)] = AtomicRequest(
                AtomicRequestType.CONDITIONAL_SURVIVAL_PROBABILITY,
                time1=float(exposure_timeline[idx]), time2=float(exposure_timeline[idx + 1]))
            self.survival_prob_requests[(idx, cp)] = AtomicRequest(
                AtomicRequestType.SURVIVAL_PROBABILITY)

    def get_requests(self):
        requests = defaultdict(list)
        for label, req in self.survival_prob_requests.items():
            requests[label].append(req)
        for label, req in self.cond_survival_prob_requests.items():
            requests[label].append(req)
        return requests

    def evaluate_numerically(self, exposures=None, resolved_requests=None, sharding=None,
                             **kwargs):
        n_dates = len(exposures)
        survival = [resolved_requests[0][r.handle] for r in self.survival_prob_requests.values()]
        cond_survival = [resolved_requests[0][r.handle]
                         for r in self.cond_survival_prob_requests.values()]
        if len(survival) != n_dates - 1:
            raise ValueError("CVA needs a survival probability for each exposure interval")
        cva_pathwise = 0.0
        for k in range(n_dates - 1):
            default_prob = survival[k] * (1.0 - cond_survival[k])
            cva_pathwise = cva_pathwise + torch.clamp(exposures[k], min=0.0) * default_prob
        return [mc_mean_and_error(cva_pathwise * (1.0 - self.recovery_rate), sharding)]


class PathwisePrimitive(enum.Enum):
    DISCOUNTED_CASHFLOWS = "discounted_cashflows"
    EXPOSURE_PROFILES = "exposure_profiles"


class RiskMetrics:
    """Metric collection deriving which pathwise primitives are needed
    (risk_metrics.py:14-58)."""

    def __init__(self, metrics: Sequence[Metric], exposure_timeline=None):
        self.metrics = list(metrics)
        self.exposure_timeline = tuple(
            float(t) for t in (() if exposure_timeline is None else exposure_timeline))

        self.any_pv = any(m.metric_type == MetricType.PV for m in self.metrics)
        self.any_xva = any(m.metric_type == MetricType.CVA for m in self.metrics)
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
        for metric in self.metrics:
            metric.set_requests(self.exposure_timeline)
        self.counterparty_ids: List[str] = [
            cp for m in self.metrics for cp in (m.get_counterparty_ids() or [])]

    def requires_discounted_cashflows(self) -> bool:
        return PathwisePrimitive.DISCOUNTED_CASHFLOWS in self._required

    def requires_exposure_profiles(self) -> bool:
        return PathwisePrimitive.EXPOSURE_PROFILES in self._required
