"""SimulationController: the end-to-end Monte Carlo pipeline.

Counterpart of ``montecarlo_risk_engine_tpu/api/controller.py``: the
constructor checks, the unified simulation timeline with the internal
exposure timeline (metric dates plus MPoR collateral query dates), the
pre-simulation and the LSM fits of the exposure profiles, simulation and
request resolution (plane or streaming), valuation into netting sets with
thresholds and MPoR collateral, the metrics (PV, CE, EPE, ENE, EEPE, PFE,
CVA), analytic PV evaluation, first- and second-order sensitivities and the
named result assembly.

Samplers (engine/engine.py): ``antithetic=True`` mirrors every draw,
``sampler="sobol"`` takes a digitally shifted Sobol sequence, and
``qmc_bridge=True`` orders its dimensions along a Brownian bridge.  The
path kernels take the pseudo-random sampler alone, so either sends a book
to the engine.

Streaming (controller.py:1746-1947).  The plane route
keeps the [T, N, D] state plane and resolves every request from it; the
streaming route resolves each point's request rows against the live state
inside the path loop (requests.EmissionSchedule) and keeps only those rows.
``streaming``: True streams, False keeps the plane, "auto" streams when
the plane estimate exceeds a budget, when 13x the plane (P x that for
Hessians) exceeds the AD budget, or when the emitted rows are at most a
quarter of the plane's, and never when they exceed twice the plane's; the
Brownian bridge's resident plane comes off the budgets first.  The budgets
are an eighth and seven eighths of the card's memory (2 GiB and 14 GiB on
the CPU).  Routes, as in the JAX package:

  * a forward book on a path kernel keeps the plane (the kernel writes it),
    unless ``streaming=True``, which wins over the kernel and takes the
    engine (with ``use_kernel=True`` too it raises);
  * a differentiated kernel book with a schedule takes kernel-streaming AD:
    the kernel's frozen draws, and a reconstruction that emits rows
    (ops/paths_ad.py, ``EMIT_PLANE_CHUNK`` coarse points at a time);
  * ``metric_streaming`` ("auto": whenever eligible; True: required) folds
    netting, collateral and the metric reductions into the main
    simulation's path loop (api/streaming_metrics.py), off the kernel
    route only; the reason a book is not eligible is kept in
    ``metric_stream_reason`` and logged.

``batch_products=True`` (the default, as in the JAX package) values the
products of each family as one batch (api/batching.py, controller.py:
275-304): European, binary, basket, Asian and barrier options, Bermudan,
American and FlexiCall options on an equity, bonds and swaps, each family
fitted on the pre-simulation and valued on the main simulation as one
table-driven computation.  The other products, and every product with
``batch_products=False``, take the per-product path.  Exercise products
(Bermudan, American, FlexiCall, Storage) are fitted on the pre-simulation
into one list of exercise executors, each valued on the main simulation
into its netting sets by one ``index_add``: the torch scans, loops over
stacked event tables, one per bucket of products of one static signature
(controller.py:490-876), and the storage kernel's executor of every storage
deal (ops/storage_scan.py ``BookDeals``, whose ``route`` decides where the
kernel takes them: a CUDA device, no derivative through the deals, no path
sharding), and the exercise kernel's executor of every family-batched
Bermudan, American and FlexiCall (ops/exercise_scan.py ``BookOptions``,
under the same rule on the state plane's rows; where it takes them their
``ExerciseEquityBatch`` batches are neither fitted nor valued).  Products
without a scan step take the per-date unrolled path.
The exercise decisions stay hard: gradients of every order flow through the
payoffs and the pre-simulation fits, never through the policy.

A PV metric of ``EvaluationType.ANALYTICAL`` takes each product's closed
form where it has one and the Monte Carlo mean of the others
(controller.py:956-1001, 1139-1144); a product all of whose metrics are
analytic is not simulated, and a book of only such products skips the
simulation (controller.py:367-380).

PyTorch runs the pipeline eagerly on ``device``.  Path generation takes one
of two routes:

  * a path kernel when the book is eligible (the model's
    ``supports_kernel_paths``, the pseudo-random sampler, no antithetic
    pairs): the Heston-QE kernel (ops/heston_qe.py) or the hybrid kernel
    (ops/hybrid_paths.py) of the Black-Scholes, BS-multi, Vasicek, CIR++,
    Hull-White and Schwartz-2F models and of ModelConfig books.  Differentiated runs rebuild
    the paths from the kernel's frozen draws under AD (ops/paths_ad.py):
    emitted draws for Heston QE, draws recovered from the states for the
    invertible hybrid steps.  In forward mode without Hessians, in float64,
    on the plane route with recovered draws and Vasicek, Black-Scholes and
    CIR++ Euler blocks only, the rebuild and its tangents are one kernel launch
    per phase and sweep (ops/recon_tangents.py, span route
    ``recon_kernel``), and likewise for Heston QE's emitted draws with the
    fuzzy branches (ops/qe_tangents.py); every other differentiated kernel
    book keeps the rebuild in torch ops (``recon``).  The kernel's
    dispatcher, not the controller, looks at the device: CUDA launches the
    kernel, the CPU runs its plain version.
  * otherwise the engine (engine/engine.py), on any device.

``use_kernel``: "auto" takes the kernel whenever eligible, True requires it
(an ineligible book raises), False forces the engine.  An injected
``noise_source`` ({phase: counter -> (z, u)}, the test seam that feeds the
JAX engine's own draws) forces the engine too.  ``bridge_source`` ((product
id, barrier index, paths, intervals) -> uniforms) is its twin for the
Brownian-bridge uniforms of barrier options (products/barrier_option.py).

Path sharding (``path_sharding=``, controller.py:89, 169; parallel/mesh.py):
each ``torch.distributed`` rank simulates and values its own share of the
paths, global paths ``rank + world_size * i``, through every route (the
engine, K1 and K2 at the rank's path offset and stride, ops/path_shard.py).
Every path-axis reduction (the metrics, the fits, the batches' Gram matrices,
PFE's order statistics) sums the ranks' fixed-tree partials in a fixed tree,
so every rank returns the same results, and each metric value has the same
bits on any number of ranks (standard errors within 1 ulp).  The ranks must
be a power of two and divide both path counts (half of them under
antithetic pairs); a sharding of one rank runs the same code.  The public
path counts are the run's; the tensors of a rank hold num_paths / R paths,
and the "auto" streaming budgets weigh a rank's share against its card.

Sensitivities take the direction the JAX package takes (controller.py:
1700-1705): forward mode when the parameter count P is at most the value
count V, else reverse mode; ``grad_mode="fwd"`` or ``"rev"`` forces one.

  * Forward: ``torch.func.jvp`` under ``torch.func.vmap`` over chunks of
    ``grad_chunk_size`` parameter tangents (the counterpart of
    ``_chunked_jacfwd``); each chunk is one pass whose primal is the
    valuation.  The kernel run and the noise recovery sit outside the
    sweeps: each phase's frozen draws are computed once per run.
  * Reverse: one recorded forward pass, then batched backwards over
    ``grad_chunk_size`` of the V metric values at a time (the JAX package's
    ``_chunked_jacrev``, controller.py:1461-1502): ``torch.autograd.grad``
    with ``is_grads_batched`` on one process, and under a path sharding (of
    any world size, one included) the functional form, ``torch.func.vjp``
    with ``vmap`` over the cotangents, since the batched backward of
    ``autograd.grad`` has no batching rule for a collective.  There rank 0
    seeds the values' cotangents, the others zeros, so each rank's gradient
    is its own paths' share (parallel/collectives.py), and the jacobian is
    their sum over the ranks in a fixed tree.  One process keeps the plain
    form: the functional one runs every op of the recorded pass through
    ``torch.func``'s wrappers, and its walls on the host-bound books were
    longer (PERF.md section 6).

Gradients flow through the pre-simulation's regression coefficients, as in
the JAX package.

Hessians (``compute_higher_derivatives()`` before ``run_simulation``,
controller.py:394, 1652-1683) are computed one row at a time: row j is the
forward tangent, in direction e_j, of the function that returns the
first-order rows, so H[i][j] = d jac[i] / d p_j and each row's memory stays
near the first order's.  On the forward branch that function is the chunked
``jvp``-under-``vmap`` sweep (forward over forward); on the reverse branch
it is a functional gradient, ``torch.func.vjp`` with ``vmap`` over the V
cotangents (forward over reverse), since ``torch.func.jvp`` cannot wrap
``torch.autograd.grad``.  The frozen kernel draws are computed once per
run, before the jacobian and every Hessian row, so a kernel book launches
its kernel once per phase whatever P is, and its Hessian is the exact
second-order pathwise derivative of the kernel's own trajectory.
"""

from __future__ import annotations

import logging
import time
from bisect import bisect_left
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import jvp, vjp, vmap

from montecarlo_risk_engine_tpu_torch import rng, tracing
from montecarlo_risk_engine_tpu_torch.api.batching import (
    EmittedTables,
    EuropeanEquityBatch,
    ExerciseEquityBatch,
    ExposureContext,
    ObservableTables,
    plan_batches,
)
from montecarlo_risk_engine_tpu_torch.api.streaming_metrics import (
    MetricStreamExecutor,
    metric_stream_ineligibility,
)
from montecarlo_risk_engine_tpu_torch.api.results import SimulationResults
from montecarlo_risk_engine_tpu_torch.config import SimulationScheme, real_dtype, resolve_device
from montecarlo_risk_engine_tpu_torch.engine.engine import simulate_paths
from montecarlo_risk_engine_tpu_torch.metrics.metrics import (
    EvaluationType,
    Metric,
    MetricType,
    RiskMetrics,
    mc_mean_and_error,
)
from montecarlo_risk_engine_tpu_torch.models.base import Model
from montecarlo_risk_engine_tpu_torch.models.hybrid import ModelConfig
from montecarlo_risk_engine_tpu_torch.ops import (
    exercise_scan, qe_tangents, recon_tangents, storage_scan,
)
from montecarlo_risk_engine_tpu_torch.ops.path_shard import (
    sharded_kernel_paths,
    sharded_kernel_paths_with_noise,
)
from montecarlo_risk_engine_tpu_torch.ops.paths_ad import (
    dense_timeline,
    emitted_noise_fns,
    recovered_noise_fns,
)
from montecarlo_risk_engine_tpu_torch.parallel.collectives import sum_over_ranks
from montecarlo_risk_engine_tpu_torch.parallel.mesh import PathSharding, local_paths
from montecarlo_risk_engine_tpu_torch.products.base import Product
from montecarlo_risk_engine_tpu_torch.products.netting_set import NettingSet
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequest, AtomicRequestType, RequestPlan
from montecarlo_risk_engine_tpu_torch.utils.regression import (
    PolynomialRegression,
    RegressionFunction,
    fit_least_squares,
)

logger = logging.getLogger(__name__)

# Metrics reported once per netting set; the others once per metric
# exposure date (controller.py:2360-2373).
_SCALAR_METRICS = {MetricType.PV, MetricType.CVA, MetricType.EEPE, MetricType.CE}
# Elements of the stacked [dates, N, deg] basis of one batched exposure fit:
# a 1,000-path book fits all its dates at once, a 1e6-path book one at a time.
_FIT_BATCH_ELEMENTS = 1 << 22


def _family(batch) -> str:
    """A family batch's name in spans: its class name without "Batch"."""
    return type(batch).__name__.removesuffix("Batch")


class SimulationController:
    def __init__(
        self,
        netting_sets: Sequence[NettingSet],
        model: Model,
        risk_metrics: RiskMetrics,
        num_paths_mainsim: int,
        num_paths_presim: int,
        num_steps: int,
        simulation_scheme: SimulationScheme,
        differentiate: bool = False,
        regression_function: Optional[RegressionFunction] = None,
        root_seed: int = 0,
        antithetic: bool = False,
        sampler: str = "pseudo",
        grad_chunk_size: int = 8,
        use_kernel: object = "auto",
        device=None,
        noise_source: Optional[Dict[int, Callable]] = None,
        bridge_source: Optional[Callable] = None,
        batch_products: bool = True,
        remat_paths: bool = False,
        streaming: object = "auto",
        qmc_bridge: bool = False,
        metric_streaming: object = "auto",
        qmc_shift_source: Optional[Dict[int, object]] = None,
        path_sharding: Optional[PathSharding] = None,
        grad_mode: str = "auto",
    ):
        self.risk_metrics = risk_metrics
        netting_sets = list(netting_sets)
        if len(netting_sets) == 0:
            raise ValueError("Provide at least one netting set.")

        seen = set()
        for ns in netting_sets:
            for product in ns.products:
                if id(product) in seen:
                    raise ValueError("A product instance cannot belong to more than one netting set.")
                seen.add(id(product))

        self.netting_sets = netting_sets
        self.products: List[Product] = [p for ns in netting_sets for p in ns.products]
        self.product_to_netting_set_idx: List[int] = []
        for ns_idx, ns in enumerate(netting_sets):
            self.product_to_netting_set_idx.extend([ns_idx] * len(ns.products))

        # Exposure timelines (controller.py:119-125, 313-332): the metric
        # dates, plus each collateralised netting set's t - MPoR query dates.
        self.metric_exposure_timeline: Tuple[float, ...] = tuple(risk_metrics.exposure_timeline)
        self.exposure_timeline = self._build_internal_exposure_timeline()
        self._exposure_time_to_idx = {t: i for i, t in enumerate(self.exposure_timeline)}
        self.metric_exposure_indices = np.array(
            [self._exposure_time_to_idx[t] for t in self.metric_exposure_timeline], dtype=int)
        self.netting_set_delayed_exposure_indices = self._build_delayed_exposure_indices()

        # Exposure-date observable requests (controller.py:127-137).
        self.numeraire_requests: Dict[Tuple[float, str], AtomicRequest] = {
            (t, "numeraire"): AtomicRequest(AtomicRequestType.NUMERAIRE, time1=t)
            for t in self.exposure_timeline
        }
        self.spot_requests: Dict[Tuple[float, str], AtomicRequest] = {
            (t, asset_id): AtomicRequest(AtomicRequestType.SPOT)
            for prod in self.products for asset_id in prod.asset_ids
            for t in self.exposure_timeline
        }

        # Analytic evaluation exists for PV only (controller.py:138-150).
        for m in risk_metrics.metrics:
            if m.evaluation_type == EvaluationType.ANALYTICAL and m.metric_type != MetricType.PV:
                raise ValueError(
                    "EvaluationType.ANALYTICAL is only supported for the PV metric; "
                    f"{m.metric_type.name} has no analytic evaluation")
        if risk_metrics.any_xva:
            if not isinstance(model, ModelConfig):
                raise ValueError("ModelConfig needs to be provided for xVA valuation.")
            missing = [cp for cp in risk_metrics.counterparty_ids if cp not in model.id_to_model]
            if missing:
                raise ValueError(f"No model simulates the counterparties {missing}.")

        self.model = model
        self.num_paths_presim = int(num_paths_presim)
        self.num_paths_mainsim = int(num_paths_mainsim)
        self.num_steps = int(num_steps)
        self.simulation_scheme = simulation_scheme
        self.differentiate = bool(differentiate)
        self.requires_higher_order_derivatives = False
        self.regression_function = regression_function or PolynomialRegression(degree=2)
        self.root_seed = int(root_seed)
        self.antithetic = bool(antithetic)
        if sampler not in ("pseudo", "sobol"):
            raise ValueError("sampler must be 'pseudo' or 'sobol'")
        if sampler == "sobol" and antithetic:
            raise ValueError("sampler='sobol' is incompatible with antithetic sampling")
        self.sampler = sampler
        if qmc_bridge and sampler != "sobol":
            raise ValueError("qmc_bridge=True requires sampler='sobol'")
        self.qmc_bridge = bool(qmc_bridge)
        self.remat_paths = bool(remat_paths)
        self.grad_chunk_size = max(1, int(grad_chunk_size))
        if streaming not in ("auto", True, False):
            raise ValueError("streaming must be 'auto', True or False")
        if metric_streaming not in ("auto", True, False):
            raise ValueError("metric_streaming must be 'auto', True or False")
        # Metric streaming needs the streaming engine (controller.py:209-217).
        if metric_streaming is True and streaming == "auto":
            streaming = True
        self.streaming = streaming
        self.metric_streaming = metric_streaming
        if use_kernel not in ("auto", True, False):
            raise ValueError("use_kernel must be 'auto', True or False")
        if use_kernel is True and streaming is True and not differentiate:
            raise ValueError(
                "use_kernel=True and streaming=True are mutually exclusive for forward-only "
                "runs: the path kernels materialise the state plane that streaming mode avoids "
                "(differentiated runs compose via in-loop row emission)")
        self.use_kernel = use_kernel
        if grad_mode not in ("auto", "fwd", "rev"):
            raise ValueError("grad_mode must be 'auto', 'fwd' or 'rev'")
        self.grad_mode = grad_mode
        self.device = resolve_device(device)
        # Path sharding (controller.py:2095-2106): every rank's share of both
        # path counts, and its tensors on the sharding's device.
        self.path_sharding = path_sharding
        if path_sharding is not None:
            if path_sharding.device.type != self.device.type:
                raise ValueError(f"path_sharding lives on {path_sharding.device}, the controller "
                                 f"on {self.device}")
            for n in (self.num_paths_mainsim, self.num_paths_presim):
                path_sharding.local_count(n, self.antithetic)
        self.noise_source = dict(noise_source) if noise_source else None
        if self.noise_source is not None and sampler == "sobol":
            raise ValueError("noise_source replaces the pseudo-random draws; sampler='sobol' "
                             "takes its shift words through qmc_shift_source")
        self.qmc_shift_source = dict(qmc_shift_source) if qmc_shift_source else None
        self._emission_schedule = None
        self._metric_stream: Optional[MetricStreamExecutor] = None
        self.metric_stream_reason: Optional[str] = None

        for prod_id, prod in enumerate(self.products):
            prod.product_id = prod_id
            if hasattr(prod, "bridge_source"):
                prod.path_sharding = path_sharding
                if bridge_source is not None:
                    prod.bridge_source = bridge_source

        if differentiate:
            self.model.requires_grad()

        # Unified simulation timeline (controller.py:253-256).
        prod_times = {t for prod in self.products for t in prod.modeling_timeline}
        self.simulation_timeline: Tuple[float, ...] = tuple(
            sorted(prod_times | set(self.exposure_timeline)))

        self._analytic_ids = {p.product_id for p in self.products
                              if self._can_skip_monte_carlo_for_product(p)}
        self.requires_regression = any(self._product_requires_regression(p)
                                       for p in self.products)
        if self.requires_regression and self.num_paths_presim <= 0:
            offenders = sorted({type(p).__name__ for p in self.products
                                if self._product_requires_regression(p)})
            raise ValueError(
                "num_paths_presim must be > 0: the book needs least-squares fits (early "
                f"exercise or LSM exposure profiles) for {offenders}, on pre-simulation paths")

        # Family batches (controller.py:275-304): every product that the
        # simulation values, grouped by family and static signature.
        self._batches, self._batched_ids = [], set()
        if batch_products:
            batchable = [p for p in self.products if p.product_id not in self._analytic_ids]
            self._batches, self._batched_ids = plan_batches(
                batchable, [self.product_to_netting_set_idx[p.product_id] for p in batchable],
                {t: i for i, t in enumerate(self.simulation_timeline)}, self.regression_function)
            for batch in self._batches:
                if (isinstance(batch, EuropeanEquityBatch)
                        and self._can_use_analytic_exposure_for_product(batch.products[0])):
                    batch.use_analytic_exposure = True
                    batch.analytic_model = self.model
        # The request plan resolves what the per-product path reads: the
        # batches resolve their own rows (api/batching.ObservableTables), so
        # their products' requests and the exposure-date spots of assets that
        # only they hold would be resolved (and, under AD, carry tangents)
        # for nothing.  The JAX package's compiler drops those resolutions.
        self._plan_products = [p for p in self.products if id(p) not in self._batched_ids]
        # The exercise scans' executors: the storage kernel's deals, the
        # exercise kernel's equity options (the ExerciseEquityBatch products),
        # and each torch scan bucket's netting sets on the device (built at
        # its first fit).
        scanned = [p for bucket in self._exercise_scan_groups()[0] for p in bucket]
        self._book_deals = storage_scan.BookDeals(
            scanned, [self.product_to_netting_set_idx[p.product_id] for p in scanned],
            self.exposure_timeline, self.regression_function, self._observation_handles,
            self.device, path_sharding)
        self._book_options = exercise_scan.BookOptions(
            [b for b in self._batches if isinstance(b, ExerciseEquityBatch)],
            self.exposure_timeline if self.risk_metrics.requires_exposure_profiles() else (),
            self.regression_function, self.device, path_sharding)
        self._bucket_segs: Dict[int, torch.Tensor] = {}
        self._all_requests = (self.spot_requests, self.numeraire_requests)
        self._use_requests(streaming=False)

        self._kernel_active = self._decide_kernel()
        self._plan: Optional[RequestPlan] = None
        self._grad_mode_resolved: Optional[str] = None  # "fwd" or "rev", set by each run

    # -- setup helpers (controller.py:313-392) ------------------------------------

    def _build_internal_exposure_timeline(self) -> Tuple[float, ...]:
        if not self.risk_metrics.requires_exposure_profiles():
            return tuple(self.metric_exposure_timeline)
        times = set(self.metric_exposure_timeline)
        for ns in self.netting_sets:
            times.update(ns.get_collateral_query_times(self.metric_exposure_timeline))
        return tuple(sorted(times))

    def _build_delayed_exposure_indices(self) -> List[np.ndarray]:
        out = []
        for ns in self.netting_sets:
            delayed = np.full(len(self.metric_exposure_timeline), -1, dtype=int)
            if ns.is_collateralized():
                for i, t in enumerate(self.metric_exposure_timeline):
                    if t - ns.margin_period_of_risk >= 0.0:
                        delayed[i] = self._exposure_time_to_idx[t - ns.margin_period_of_risk]
            out.append(delayed)
        return out

    def _can_use_analytic_exposure_for_product(self, product: Product) -> bool:
        # Pathwise closed-form exposures serve every exposure aggregation but
        # CVA (controller.py:350-365).
        supported = {MetricType.PV, MetricType.EPE, MetricType.ENE, MetricType.CE,
                     MetricType.EEPE, MetricType.PFE}
        return (all(m.metric_type in supported for m in self.risk_metrics.metrics)
                and product.supports_analytic_exposure(self.model))

    def _product_requires_regression(self, product: Product) -> bool:
        if len(product.regression_timeline) > 0:
            return True
        return (self.risk_metrics.requires_exposure_profiles()
                and not self._can_use_analytic_exposure_for_product(product))

    def _can_evaluate_metric_analytically(self, product: Product, metric: Metric) -> bool:
        return (metric.metric_type == MetricType.PV
                and metric.evaluation_type == EvaluationType.ANALYTICAL
                and product.supports_analytic_pv(self.model))

    def _can_skip_monte_carlo_for_product(self, product: Product) -> bool:
        """Every metric of the product is its closed form (controller.py:374-380)."""
        if self.risk_metrics.requires_exposure_profiles():
            return False
        return all(self._can_evaluate_metric_analytically(product, m)
                   for m in self.risk_metrics.metrics)

    def compute_higher_derivatives(self) -> None:
        """Ask a differentiated run for Hessians too (controller.py:394)."""
        self.requires_higher_order_derivatives = True

    def _get_requests(self):
        requests = defaultdict(set)
        for label, req in self.numeraire_requests.items():
            requests[label].add(req)
        for label, req in self.spot_requests.items():
            requests[label].add(req)
        for metric in self.risk_metrics.metrics:
            for label, reqs in metric.get_requests().items():
                requests[label].update(reqs)
        return requests

    def _decide_kernel(self) -> bool:
        """The plain rule that replaces the JAX package's ``_decide_pallas``.
        A forward book's explicit ``streaming=True`` wins over the kernel
        (controller.py:2057-2064)."""
        if self.streaming is True and not self.differentiate:
            return False
        eligible = (
            self.model.supports_kernel_paths(self.simulation_scheme)
            and self.sampler == "pseudo"
            and not self.antithetic
        )
        if self.use_kernel is True:
            if not eligible:
                scheme = self.simulation_scheme.name
                why = (f"{type(self.model).__name__} has no path kernel under {scheme} "
                       "(its supports_kernel_paths)"
                       if not self.model.supports_kernel_paths(self.simulation_scheme)
                       else "the path kernels need sampler='pseudo' and antithetic=False")
                raise ValueError(f"use_kernel=True but the book is not kernel-eligible: {why}")
            if self.noise_source is not None:
                raise ValueError("use_kernel=True contradicts an injected noise_source")
            return True
        if self.use_kernel is False or self.noise_source is not None:
            return False
        return eligible

    def _use_requests(self, streaming: bool) -> None:
        """The exposure-date requests of the plan: all of them on the
        streaming route, which has no plane to resolve the batches' rows
        from afterwards; else only those the per-product path reads."""
        spot, numeraire = self._all_requests
        if not streaming:
            plan_assets = {a for p in self._plan_products for a in p.asset_ids}
            spot = {k: v for k, v in spot.items() if k[1] in plan_assets}
            numeraire = numeraire if self._plan_products else {}
        self.spot_requests, self.numeraire_requests = spot, numeraire

    def _ensure_plan(self) -> None:
        with tracing.span("plan"):
            if self._plan is None:
                self._decide_streaming()

    def _build_plan(self, products) -> RequestPlan:
        plan = RequestPlan(self.model)
        plan.collect_and_index_requests(products, self.simulation_timeline, self._get_requests(),
                                        self.metric_exposure_timeline)
        return plan

    # Budgets of the "auto" streaming decision where the device tells no
    # memory size (the CPU): stream once the plane would exceed the first,
    # or its AD-amplified estimate the second (controller.py:1960-1965).
    STREAMING_AUTO_THRESHOLD_BYTES = 2 << 30
    STREAMING_AUTO_AD_BUDGET_BYTES = 14 << 30

    def _auto_memory_budgets(self):
        """(plane threshold, AD budget): an eighth and seven eighths of the
        card's memory, the JAX package's ratios (controller.py:2004-2018)."""
        if self.device.type != "cuda":
            return self.STREAMING_AUTO_THRESHOLD_BYTES, self.STREAMING_AUTO_AD_BUDGET_BYTES
        hbm = torch.cuda.get_device_properties(self.device).total_memory
        return hbm // 8, hbm - hbm // 8

    def _qmc_bridge_resident_bytes(self, num_paths: int) -> int:
        """Bytes the Brownian bridge holds in either route, counted as the JAX
        package counts them (controller.py:1949-1958): the rotated [T_sub, N,
        sim_dim] plane and the [N, levels, sim_dim] Sobol normals it is built
        from (both live while it is built); 0 without the bridge."""
        if not self.qmc_bridge:
            return 0
        t_sub = len(self.simulation_timeline) * max(1, self.num_steps)
        itemsize = torch.finfo(real_dtype()).bits // 8
        return 2 * t_sub * self.model.simulation_dim * num_paths * itemsize

    def _decide_streaming(self) -> None:
        """The request plan, and plane or streaming once it exists
        (controller.py:1746-1947): see the module docstring for the rule."""
        mode = False if (self._kernel_active and not self.differentiate) else self.streaming
        schedule = None
        if mode is not False:
            self._use_requests(streaming=True)
            self._plan = self._build_plan(self.products)
            schedule = self._plan.build_emission_schedule(len(self.simulation_timeline))
        if mode == "auto":
            plane_rows = max(len(self.simulation_timeline) * self.model.state_dim, 1)
            emitted_rows = schedule.num_emitted_rows()
            num_paths = max(self._local(self.num_paths_mainsim),
                            self._local(self.num_paths_presim))
            plane_bytes = plane_rows * num_paths * (torch.finfo(real_dtype()).bits // 8)
            amp = 1.0
            if self.differentiate:
                amp = 13.0
                if self.requires_higher_order_derivatives:
                    amp *= max(1, len(self.model.initial_params()))
            plane_threshold, ad_budget = self._auto_memory_budgets()
            bridge_bytes = self._qmc_bridge_resident_bytes(num_paths)
            if bridge_bytes:
                plane_threshold = max(plane_threshold - bridge_bytes, plane_threshold // 8)
                ad_budget = max(ad_budget - bridge_bytes, ad_budget // 8)
            if emitted_rows > 2 * plane_rows:
                mode = False
            else:
                mode = (plane_bytes > plane_threshold or amp * plane_bytes > ad_budget
                        or emitted_rows * 4 <= plane_rows)
        if mode:
            self._emission_schedule = schedule
        else:
            self._emission_schedule = None
            self._use_requests(streaming=False)
            self._plan = self._build_plan(self._plan_products)
        self._metric_stream, self.metric_stream_reason = None, None
        if self.metric_streaming is not False:
            reason = metric_stream_ineligibility(self)
            if reason is None:
                self._metric_stream = MetricStreamExecutor(self)
                logger.info("streaming metric pipeline: on")
            elif self.metric_streaming is True:
                raise ValueError(f"metric_streaming=True but the book is ineligible: {reason}")
            else:
                self.metric_stream_reason = reason
                logger.info("streaming metric pipeline: off (%s)", reason)
        if self._emission_schedule is not None and self.qmc_bridge:
            logger.warning(
                "qmc_bridge keeps a [T_sub, N, sim_dim] rotated plane and its Sobol normals "
                "(%.2f GiB) through the path loop, so streaming memory does not scale as "
                "O(request rows x paths) on this book",
                self._qmc_bridge_resident_bytes(max(self._local(self.num_paths_mainsim),
                                                    self._local(self.num_paths_presim))) / 2**30)

    @staticmethod
    def _make_unique_names(base_names: List[str]) -> List[str]:
        counts: Dict[str, int] = defaultdict(int)
        unique = []
        for name in base_names:
            counts[name] += 1
            unique.append(name if counts[name] == 1 else f"{name}#{counts[name]}")
        return unique

    # -- simulation -------------------------------------------------------------

    def _simulates(self) -> bool:
        """Whether any product is valued on paths (a book of closed forms
        only is not simulated)."""
        return len(self._analytic_ids) < len(self.products)

    def _local(self, num_paths: int) -> int:
        """This rank's share of ``num_paths`` (all of it without a sharding)."""
        return local_paths(num_paths, self.path_sharding)[0]

    def _phases(self):
        """(phase, num_paths) of every simulation a run makes."""
        if not self._simulates():
            return []
        phases = [(rng.PHASE_MAINSIM, self.num_paths_mainsim)]
        if self.requires_regression:
            phases.append((rng.PHASE_PRESIM, self.num_paths_presim))
        return phases

    def _kernel_ad_fns(self, num_paths: int, phase: int, emit_schedule=None):
        """(forward_coarse, noise_fn, recon_fn) of the differentiated kernel
        route for one phase (controller.py:1192-1257), on this rank's paths;
        with an ``emit_schedule`` they return the schedule's rows
        (kernel-streaming AD).  Where :meth:`_recon_kernel` names a module,
        the plane's ``recon_fn`` is its reconstruction kernel's."""
        dense, _ = dense_timeline(self.model.calibration_date, self.simulation_timeline,
                                  self.num_steps)
        scheme, n = self.simulation_scheme, self._local(num_paths)
        if self.model.kernel_ad_mode(scheme) == "emit":
            def noise_forward(p):
                return sharded_kernel_paths_with_noise(
                    self.model, p, scheme, dense, num_paths, self.root_seed, phase,
                    self.path_sharding)

            fns = emitted_noise_fns(self.model, scheme, self.simulation_timeline,
                                    n, self.num_steps, noise_forward, emit_schedule)
        else:
            def dense_forward(p):
                return sharded_kernel_paths(self.model, p, scheme, dense, num_paths, 1,
                                            self.root_seed, phase, self.path_sharding)

            fns = recovered_noise_fns(self.model, scheme, self.simulation_timeline,
                                      n, self.num_steps, dense_forward, emit_schedule)
        kernel = self._recon_kernel()  # None with an emission schedule
        if kernel is not None:
            fns = fns[:2] + (kernel.reconstruction(
                self.model, scheme, self.simulation_timeline, self.num_steps,
                self.grad_chunk_size),)
        return fns

    def _recon_kernel(self):
        """The module whose forward-mode kernel rebuilds the differentiated
        kernel route's plane, or None where the torch rebuild keeps it.  A
        kernel needs forward mode, no Hessian, the float64 working dtype (its
        own) and the plane route (no emission schedule), and a path sharding
        is no reason to fall back; then ops/recon_tangents.py takes draws
        recovered from the states on Vasicek, Black-Scholes and CIR++ Euler
        blocks, ops/qe_tangents.py the Heston QE path kernel's emitted draws
        with the fuzzy branches (each module's ``model_supported``)."""
        if (self._grad_mode_resolved != "fwd" or self.requires_higher_order_derivatives
                or real_dtype() != torch.float64 or self._emission_schedule is not None):
            return None
        return next((m for m in (recon_tangents, qe_tangents)
                     if m.model_supported(self.model, self.simulation_scheme)), None)

    def _kernel_noise_of(self, params):
        """Frozen draws {phase: noise} of the differentiated kernel route: one
        kernel run and one noise recovery per phase, outside every tangent
        sweep (controller.py:1259-1271)."""
        noise = {}
        for phase, n in self._phases():
            with tracing.span("kernel_noise", phase=phase):
                noise[phase] = self._kernel_ad_fns(n, phase)[1](params)
        return noise

    def _engine_kw(self, phase: int):
        """The engine's sampler keywords and test seams for one phase."""
        return dict(root_seed=self.root_seed, noise_source=(self.noise_source or {}).get(phase),
                    antithetic=self.antithetic, sampler=self.sampler,
                    qmc_bridge=self.qmc_bridge, remat=self.remat_paths,
                    qmc_shift=(self.qmc_shift_source or {}).get(phase), device=self.device,
                    path_sharding=self.path_sharding)

    def _simulate_and_resolve(self, params, num_paths: int, phase: int, kernel_noise=None):
        """One simulation pass of ``num_paths`` paths -> (resolved handle
        lists, the batches' observable tables or None) of this rank's share,
        from the [T, N, D] state plane or, with an emission schedule, from the
        rows emitted in the path loop (controller.py:1273-1340)."""
        schedule, n = self._emission_schedule, self._local(num_paths)
        if schedule is not None:
            if self._kernel_active:
                # Kernel-streaming AD (differentiated runs only): the
                # reconstruction on the kernel's frozen draws emits the rows.
                with tracing.span("paths", phase=phase, paths=num_paths, route="recon_rows"):
                    _, noise_fn, recon_rows = self._kernel_ad_fns(num_paths, phase, schedule)
                    noise = kernel_noise[phase] if kernel_noise is not None else noise_fn(params)
                    emissions = recon_rows(params, noise)
                    emissions = [e.to(real_dtype()) for e in emissions]
            else:
                with tracing.span("paths", phase=phase, paths=num_paths, route="engine_rows"):
                    _, emissions = simulate_paths(
                        self.model, params, self.simulation_scheme, self.simulation_timeline,
                        num_paths, self.num_steps, phase, emit_schedule=schedule,
                        collect_states=False, **self._engine_kw(phase))
                    emissions = [e.to(real_dtype()) for e in emissions]
            with tracing.span("resolve", phase=phase):
                tables = (EmittedTables(self._plan, schedule, emissions, params, n,
                                        self.path_sharding) if self._batches else None)
                return self._plan.resolve_from_emissions(schedule, emissions), tables
        if self._kernel_active:
            if self.differentiate:
                route = "recon" if self._recon_kernel() is None else "recon_kernel"
                with tracing.span("paths", phase=phase, paths=num_paths, route=route):
                    _, noise_fn, recon_fn = self._kernel_ad_fns(num_paths, phase)
                    noise = kernel_noise[phase] if kernel_noise is not None else noise_fn(params)
                    states = recon_fn(params, noise)
            else:
                with tracing.span("paths", phase=phase, paths=num_paths, route="kernel"):
                    states = sharded_kernel_paths(
                        self.model, params, self.simulation_scheme, self.simulation_timeline,
                        num_paths, self.num_steps, self.root_seed, phase, self.path_sharding,
                    ).to(real_dtype())
        else:
            with tracing.span("paths", phase=phase, paths=num_paths, route="engine"):
                states = simulate_paths(
                    self.model, params, self.simulation_scheme, self.simulation_timeline,
                    num_paths, self.num_steps, phase, **self._engine_kw(phase))
        with tracing.span("resolve", phase=phase):
            tables = (ObservableTables(self.model, params, states, n, self.path_sharding)
                      if self._batches else None)
            return self._plan.resolve_requests(params, states), tables

    # -- LSM regression (controller.py:399-477) -------------------------------------

    def _initial_hypothetical_state(self, product: Product, num_paths: int):
        """Every state once per path, [N, S]: float for continuous states
        (Storage), integer otherwise (controller.py:399-405)."""
        dtype = real_dtype() if product.state_is_continuous() else torch.long
        row = torch.arange(product.get_num_states(), dtype=dtype, device=self.device)
        return row.expand(num_paths, -1)

    def _initial_state(self, product: Product, shape):
        """The realized initial state, in the product's state dtype."""
        dtype = real_dtype() if product.state_is_continuous() else torch.long
        return torch.full(shape, product.get_initial_state(), dtype=dtype, device=self.device)

    def _perform_regression_for_product(self, product: Product, params, resolved):
        """Backward induction over the product's regression dates and the
        exposure dates on pre-simulation paths: sets
        ``product.regression_coeffs`` [len(regression timeline), S, deg] (read
        by its per-date exercise step) and returns the exposure coefficients
        [len(exposure timeline), S, deg], zero after the last cashflow."""
        regression_times = sorted(set(product.regression_timeline) | set(self.exposure_timeline))
        product_timeline = product.product_timeline
        product_reg_timeline = product.regression_timeline
        num_states = product.get_num_states()
        num_paths = self._local(self.num_paths_presim)
        dtype = real_dtype()
        zero = torch.zeros((num_states, self.regression_function.get_degree()), dtype=dtype,
                           device=self.device)
        # rows are filled from the last date back: the exercise step at a
        # later date reads its row while an earlier date is being fitted
        product.regression_coeffs = [zero] * len(product_reg_timeline)
        exposure_coeffs = [zero] * len(self.exposure_timeline)
        pending = []  # (exposure index, basis, targets) of the exposure-only dates

        last_cf_index = len(product_timeline)
        cf_cache = {last_cf_index: torch.zeros((num_paths, num_states), dtype=dtype,
                                               device=self.device)}
        for t_reg in reversed(regression_times):
            idx = bisect_left(product_timeline, t_reg)
            if idx >= len(product_timeline):
                continue
            t_next = idx + 1 if product_timeline[idx] == t_reg else idx
            if t_next < last_cf_index:
                # Roll the hypothetical states through the uncached window,
                # then stitch the cached tail by state lookup.
                state_matrix = self._initial_hypothetical_state(product, num_paths)
                step_value = torch.zeros((num_paths, num_states), dtype=dtype, device=self.device)
                for window_idx in range(t_next, last_cf_index):
                    state_matrix, cfs = product.compute_normalized_cashflows(
                        window_idx, self.model, params, resolved, self.regression_function,
                        state_matrix)
                    step_value = step_value + cfs
                total_cfs = step_value + product.lookup_state_values(
                    cf_cache[last_cf_index], state_matrix)
                cf_cache[t_next] = total_cfs
                last_cf_index = t_next
            else:
                total_cfs = cf_cache[t_next]

            i_t = product_timeline.index(t_reg) if t_reg in product_reg_timeline else None
            explanatory, numeraire = (resolved[0][h]
                                      for h in self._observation_handles(product, t_reg, i_t))
            numeraire_col = numeraire[:, None] if numeraire.dim() == 1 else numeraire
            basis = self.regression_function.get_regression_matrix(
                torch.broadcast_to(explanatory, (num_paths,)))
            targets = torch.broadcast_to(numeraire_col * total_cfs, (num_paths, num_states))
            if t_reg in product_reg_timeline:
                coeffs = fit_least_squares(basis, targets, sharding=self.path_sharding)
                product.regression_coeffs[product_reg_timeline.index(t_reg)] = coeffs
                if t_reg in self._exposure_time_to_idx:
                    exposure_coeffs[self._exposure_time_to_idx[t_reg]] = coeffs
            else:
                pending.append((self._exposure_time_to_idx[t_reg], basis, targets))
        # The exposure-only fits feed no exercise step: batched solves, as many
        # dates at a time as keep the stacked basis under _FIT_BATCH_ELEMENTS.
        group = max(1, _FIT_BATCH_ELEMENTS // (num_paths * self.regression_function.get_degree()))
        for start in range(0, len(pending), group):
            chunk = pending[start:start + group]
            coeffs = fit_least_squares(torch.stack([c[1] for c in chunk]),
                                       torch.stack([c[2] for c in chunk]),
                                       sharding=self.path_sharding)
            for (exp_idx, _, _), c in zip(chunk, coeffs.unbind(0)):
                exposure_coeffs[exp_idx] = c
        product.regression_coeffs = (torch.stack(product.regression_coeffs)
                                     if product_reg_timeline else None)
        return torch.stack(exposure_coeffs) if exposure_coeffs else None

    # -- exercise products: the event scans (controller.py:490-723) -------------------
    #
    # A product with one decision per date runs its LSM backward induction and
    # its forward valuation as a loop over dense event tables (its dates and
    # the exposure dates, [E, N] rows) instead of the per-date unrolled path.
    # Products of one static signature run as a bucket: every tensor carries a
    # leading product axis ([P, E, N] tables, [P, N, S] states, batched fits),
    # so 1,800 Americans cost one loop per bucket, not one per product.  A
    # product alone is a bucket of one.

    def _supports_exercise_scan(self, product: Product) -> bool:
        return (hasattr(product, "scan_exercise_step")
                and len(product.product_timeline) > 0
                and tuple(product.regression_timeline) == tuple(product.product_timeline))

    def _exercise_bucket_key(self, product: Product):
        """Static signature (controller.py:760-778): bucket-mates share shapes
        and flags, never values; every per-date number rides in the tables."""
        extras = product.scan_event_extras()
        sig = None if extras is None else tuple((k, np.shape(v)) for k, v in sorted(extras.items()))
        e_tot = len(set(product.product_timeline) | set(self.exposure_timeline))
        return (type(product).__name__, e_tot, product.get_num_states(),
                product.state_is_continuous(), product.get_initial_state(), sig)

    def _exercise_scan_groups(self):
        """(scan buckets, products on the per-date unrolled path) among the
        products that need a regression, in book order (controller.py:733-758).
        A product whose ``scan_bucket_statics`` is None stays alone."""
        by_key: Dict[tuple, List[Product]] = {}
        plain = []
        for product in self.products:
            if id(product) in self._batched_ids or not self._product_requires_regression(product):
                continue
            if self._supports_exercise_scan(product):
                statics = product.scan_bucket_statics()
                key = (("single", id(product)) if statics is None
                       else self._exercise_bucket_key(product) + (statics,))
                by_key.setdefault(key, []).append(product)
            else:
                plain.append(product)
        return list(by_key.values()), plain

    def _exercise_event_tables(self, products: Sequence[Product], resolved, num_paths: int):
        """Stacked event tables of a bucket (controller.py:497-553): per
        product its dates and the exposure dates in time order, rows of the
        explanatory spot, numeraire and underlying value [P, E, N], the strike
        [P, E], the product-row mask [P, E], the extras rows {name: [P, E,
        ...]} (None without extras) and, per product, the rows of its dates
        and of the exposure dates (in exposure-timeline order)."""
        dtype = real_dtype()
        zeros = torch.zeros((num_paths,), dtype=dtype, device=self.device)
        expl, num, und, strike, is_prod, extras_rows, prod_rows, exp_rows = ([] for _ in range(8))
        for product in products:
            prod_time_to_idx = {t: i for i, t in enumerate(product.product_timeline)}
            strikes = product.scan_event_strikes()
            e_rows, n_rows, u_rows, s_row, p_row, x_idx, p_rows, x_rows = ([] for _ in range(8))
            for row, t in enumerate(sorted(set(product.product_timeline)
                                           | set(self.exposure_timeline))):
                i = prod_time_to_idx.get(t)
                e, n = (resolved[0][h] for h in self._observation_handles(product, t, i))
                if i is not None:
                    u = (resolved[1][product.underlying_requests[i].get_handle()]
                         if i in product.underlying_requests else zeros)
                    s_row.append(strikes[i])
                    p_row.append(True)
                    x_idx.append(i)
                    p_rows.append(row)
                else:
                    u = zeros
                    s_row.append(0.0)
                    p_row.append(False)
                    x_idx.append(0)  # any valid row: the step's result is masked out
                if t in self._exposure_time_to_idx:
                    x_rows.append(row)
                e_rows.append(torch.broadcast_to(e, (num_paths,)))
                n_rows.append(torch.broadcast_to(n, (num_paths,)))
                u_rows.append(torch.broadcast_to(u, (num_paths,)))
            expl.append(torch.stack(e_rows))
            num.append(torch.stack(n_rows))
            und.append(torch.stack(u_rows))
            strike.append(s_row)
            is_prod.append(p_row)
            extras = product.scan_event_extras()
            extras_rows.append(None if extras is None
                               else {k: np.asarray(v)[x_idx] for k, v in extras.items()})
            prod_rows.append(np.asarray(p_rows, dtype=np.int64))
            exp_rows.append(np.asarray(x_rows, dtype=np.int64))
        as_t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), dtype=dt, device=self.device)
        extras = None if extras_rows[0] is None else {
            k: as_t(np.stack([x[k] for x in extras_rows])) for k in extras_rows[0]}
        return {"expl": torch.stack(expl), "num": torch.stack(num), "und": torch.stack(und),
                "strike": as_t(strike), "is_prod": as_t(is_prod, torch.bool), "extras": extras,
                "prod_rows": prod_rows, "exp_rows": exp_rows}

    @staticmethod
    def _event(tables, e):
        """Row ``e`` of every table: ([P, N] expl, num, und; [P] strike,
        is_prod; extras {name: [P, ...]} or None)."""
        extras = tables["extras"]
        return (tables["expl"][:, e], tables["num"][:, e], tables["und"][:, e],
                tables["strike"][:, e], tables["is_prod"][:, e],
                None if extras is None else {k: v[:, e] for k, v in extras.items()})

    def _scan_step(self, rep: Product, state, und, expl, num, strike, coeffs, extras_e):
        args = (self.regression_function, state, und, expl, num, strike, coeffs)
        return rep.scan_exercise_step(*args) if extras_e is None else rep.scan_exercise_step(
            *args, extras_e)

    def _exercise_backward_scan(self, products: Sequence[Product], num_paths: int, tables):
        """The LSM fit of a bucket, last event first (controller.py:555-594):
        coeffs [P, E, S, deg].  The carry [P, N, S] holds each hypothetical
        state's future cashflows."""
        rep = products[0]
        num_events = tables["expl"].shape[1]
        state0 = self._initial_hypothetical_state(rep, num_paths).expand(
            len(products), -1, -1)
        carry = torch.zeros((len(products), num_paths, rep.get_num_states()), dtype=real_dtype(),
                            device=self.device)
        coeffs_all = [None] * num_events
        for e in reversed(range(num_events)):
            expl, num, und, strike, is_prod, extras_e = self._event(tables, e)
            basis = self.regression_function.get_regression_matrix(expl)
            weights = rep.scan_regression_weights(und, strike)
            if weights is not None:
                # exposure-only rows carry dummy underlying values: the
                # all-path fit there (weights only shape exercise decisions)
                weights = torch.where(is_prod[:, None], weights, torch.ones_like(weights))
            coeffs = fit_least_squares(basis, num[..., None] * carry, weights=weights,
                                       sharding=self.path_sharding)
            next_state, cfs = self._scan_step(rep, state0, und, expl, num, strike, coeffs,
                                              extras_e)
            updated = cfs + rep.lookup_state_values(carry, next_state)
            carry = torch.where(is_prod[:, None, None], updated, carry)
            coeffs_all[e] = coeffs
        return torch.stack(coeffs_all, dim=1)

    def _exercise_forward_scan(self, products: Sequence[Product], num_paths: int, coeffs_all,
                               tables, want_exposures: bool, want_states: bool = False):
        """The valuation of a bucket, first event first (controller.py:616-651):
        (cashflows [P, N], continuation exposures [P, E, N] or None, realized
        states [P, E, N] or None)."""
        rep = products[0]
        state = self._initial_state(rep, (len(products), num_paths, 1))
        cfs = torch.zeros((len(products), num_paths), dtype=real_dtype(), device=self.device)
        exposures, states = [], []
        for e in range(tables["expl"].shape[1]):
            expl, num, und, strike, is_prod, extras_e = self._event(tables, e)
            coeffs = coeffs_all[:, e]
            next_state, step_cfs = self._scan_step(rep, state, und, expl, num, strike, coeffs,
                                                   extras_e)
            state = torch.where(is_prod[:, None, None], next_state, state)
            cfs = cfs + torch.where(is_prod[:, None], step_cfs[..., 0],
                                    torch.zeros_like(step_cfs[..., 0]))
            if want_exposures:
                continuation = rep.compute_continuation_values(
                    explanatory=expl, regression_function=self.regression_function,
                    state_matrix=state, coeffs_all_states=coeffs)[..., 0]
                exposures.append(continuation / num)
            if want_states:
                states.append(state[..., 0])
        return (cfs, torch.stack(exposures, dim=1) if want_exposures else None,
                torch.stack(states, dim=1) if want_states else None)

    def _fit_exercise_bucket(self, products: Sequence[Product], resolved):
        """The bucket's fit on pre-simulation paths (controller.py:791-806):
        coeffs [P, E, S, deg]; each product's ``regression_coeffs`` are its
        own dates' rows."""
        n = self._local(self.num_paths_presim)
        tables = self._exercise_event_tables(products, resolved, n)
        with self._exercise_span(products, tables, "fit"):
            coeffs = self._exercise_backward_scan(products, n, tables)
        for i, product in enumerate(products):
            product.regression_coeffs = self._take_rows(coeffs[i], tables["prod_rows"][i])
        return coeffs

    def _bucket_seg(self, products: Sequence[Product]) -> torch.Tensor:
        """A bucket's netting sets [P] on the device, built at its first fit."""
        seg = self._bucket_segs.get(id(products[0]))
        if seg is None:
            seg = torch.as_tensor([self.product_to_netting_set_idx[p.product_id]
                                   for p in products], device=self.device)
            self._bucket_segs[id(products[0])] = seg
        return seg

    @staticmethod
    def _exercise_span(products: Sequence[Product], tables, phase: str):
        """The ``exercise`` span of one scan over a bucket's event tables."""
        return tracing.span("exercise", kind=type(products[0]).__name__, products=len(products),
                            steps=int(tables["expl"].shape[1]), phase=phase, route="torch")

    @staticmethod
    def _take_rows(x, rows: np.ndarray):
        """``x[rows]`` along the first axis."""
        return x.index_select(0, torch.as_tensor(rows, device=x.device))

    def _evaluate_exercise_bucket(self, products: Sequence[Product], coeffs, resolved):
        """The bucket on main-simulation paths (controller.py:808-873):
        (cashflows [P, N], exposure profiles [P, T_exp, N] or None)."""
        n = self._local(self.num_paths_mainsim)
        tables = self._exercise_event_tables(products, resolved, n)
        want = self.risk_metrics.requires_exposure_profiles() and len(self.exposure_timeline) > 0
        with self._exercise_span(products, tables, "value"):
            cfs, exposures, _ = self._exercise_forward_scan(products, n, coeffs, tables, want)
        if want:
            rows = torch.as_tensor(np.stack(tables["exp_rows"]), device=self.device)  # [P, T_exp]
            exposures = torch.gather(exposures, 1, rows[:, :, None].expand(-1, -1, n))
        return cfs, exposures

    def _observation_handles(self, product: Product, t: float, i: Optional[int]):
        """The (spot, numeraire) request handles an exercise product reads at
        time t: of its own date i, or of the exposure date t (i None)."""
        asset = product.asset_ids[0]
        if i is None:
            return (self.spot_requests[(t, asset)].handle,
                    self.numeraire_requests[(t, "numeraire")].handle)
        return product.spot_requests[(i, asset)].handle, product.numeraire_requests[i].handle

    def simulate_exercise_states(self, product: Product) -> np.ndarray:
        """Realized states [len(product timeline), N] of one exercise product
        under its LSM policy (controller.py:677-723): the pre-simulation fit
        and the main-simulation forward scan of this product alone, on the
        paths ``run_simulation`` draws (kernel route included); this rank's
        paths under a path sharding."""
        if not self._supports_exercise_scan(product):
            raise ValueError(f"{type(product).__name__} has no scan-executor path")
        if id(product) in self._batched_ids:
            raise ValueError(f"{type(product).__name__} is valued in a family batch: build the "
                             "controller with batch_products=False to follow its states")
        self._ensure_plan()
        params = self.model.initial_params(device=self.device, dtype=real_dtype())
        with torch.no_grad():
            n_pre, n_main = self._local(self.num_paths_presim), self._local(self.num_paths_mainsim)
            pre, _ = self._simulate_and_resolve(params, self.num_paths_presim, rng.PHASE_PRESIM)
            tables = self._exercise_event_tables([product], pre, n_pre)
            coeffs = self._exercise_backward_scan([product], n_pre, tables)
            del pre
            main, _ = self._simulate_and_resolve(params, self.num_paths_mainsim,
                                                 rng.PHASE_MAINSIM)
            tables = self._exercise_event_tables([product], main, n_main)
            _, _, states = self._exercise_forward_scan([product], n_main, coeffs,
                                                       tables, False, want_states=True)
        return self._take_rows(states[0], tables["prod_rows"][0]).cpu().numpy()

    # -- valuation (controller.py:877-1173) ---------------------------------------

    def _evaluate_product(self, product: Product, params, resolved, exposure_coeffs):
        """The per-date unrolled path: (numeraire-deflated cashflows [N],
        exposure profiles [E, N] or None)."""
        num_paths = self._local(self.num_paths_mainsim)
        dtype = real_dtype()
        state_matrix = self._initial_state(product, (num_paths, 1))
        cfs = torch.zeros((num_paths,), dtype=dtype, device=self.device)
        exposures = []
        product_timeline = product.product_timeline
        t_start = 0

        def advance(t_limit, state_matrix, cfs, t_start):
            while t_start < len(product_timeline) and (
                    t_limit is None or product_timeline[t_start] <= t_limit):
                state_matrix, new_cfs = product.compute_normalized_cashflows(
                    t_start, self.model, params, resolved, self.regression_function,
                    state_matrix)
                cfs = cfs + new_cfs[:, 0]
                t_start += 1
            return state_matrix, cfs, t_start

        if not self.risk_metrics.requires_exposure_profiles():
            state_matrix, cfs, t_start = advance(None, state_matrix, cfs, t_start)
            return cfs, None

        analytic = self._can_use_analytic_exposure_for_product(product)
        for t in self.exposure_timeline:
            state_matrix, cfs, t_start = advance(t, state_matrix, cfs, t_start)
            numeraire = resolved[0][self.numeraire_requests[(t, "numeraire")].handle]
            spot = resolved[0][self.spot_requests[(t, product.asset_ids[0])].handle]
            if analytic:
                exposure = product.compute_discounted_exposure_analytically(
                    exposure_time=t, spot=spot, numeraire=numeraire, model=self.model,
                    params=params)
            else:
                continuation = product.compute_continuation_values(
                    explanatory=torch.broadcast_to(spot, (num_paths,)),
                    regression_function=self.regression_function,
                    state_matrix=state_matrix,
                    coeffs_all_states=exposure_coeffs[self._exposure_time_to_idx[t]])[:, 0]
                exposure = continuation / numeraire
            exposures.append(torch.broadcast_to(exposure, (num_paths,)))
        if self.risk_metrics.requires_discounted_cashflows():
            state_matrix, cfs, t_start = advance(None, state_matrix, cfs, t_start)
        return cfs, torch.stack(exposures)

    def _zero_metric_result(self, metric: Metric):
        n_evals = 1 if metric.metric_type in _SCALAR_METRICS else len(self.metric_exposure_timeline)
        zero = torch.zeros((), dtype=real_dtype(), device=self.device)
        return [(zero, zero) for _ in range(n_evals)]

    def _evaluate_netting_set(self, ns_idx: int, netting_set, cfs, netted_exposures, resolved,
                              analytic, has_pathwise: bool):
        """Every metric of one netting set.  ``analytic``: per metric, the
        sum of the closed-form values of the products that skip the
        simulation; an analytic PV adds the Monte Carlo mean of the others,
        whose standard error it reports (zero without them,
        controller.py:990-1000)."""
        exposure_list = []
        if netted_exposures is not None:
            unsecured = netting_set.compute_unsecured_exposure_profiles(
                netted_exposures=netted_exposures,
                exposure_timeline=self.exposure_timeline,
                metric_exposure_indices=self.metric_exposure_indices,
                delayed_exposure_indices=self.netting_set_delayed_exposure_indices[ns_idx],
            )
            exposure_list = list(unsecured.unbind(0))
        results = []
        for metric_idx, metric in enumerate(self.risk_metrics.metrics):
            # CVA is gated on the counterparty (controller.py:982-989).
            if (metric.metric_type == MetricType.CVA and netting_set.counterparty_id is not None
                    and getattr(metric, "counterparty_id", None) != netting_set.counterparty_id):
                results.append(self._zero_metric_result(metric))
                continue
            if (metric.metric_type == MetricType.PV
                    and metric.evaluation_type == EvaluationType.ANALYTICAL):
                value = analytic[metric_idx]
                if has_pathwise:
                    numeric, err = mc_mean_and_error(cfs, self.path_sharding)
                else:
                    numeric, err = torch.zeros_like(value), torch.zeros_like(value)
                results.append([(value + numeric, err)])
                continue
            results.append(metric.evaluate(exposures=exposure_list, cfs=cfs,
                                           resolved_requests=resolved, netting_set=netting_set,
                                           model=self.model, sharding=self.path_sharding))
        return results

    def _evaluate_batches(self, batches, tables, cfs_acc, exp_acc):
        """The family ``batches`` into their netting sets (controller.py:
        1036-1082): cashflows [n_ns, N] added to ``cfs_acc``, exposure
        profiles [T_exp, N] to ``exp_acc``; returns the new ``cfs_acc``."""
        ctx = self._exposure_ctx()
        need_cfs = self.risk_metrics.requires_discounted_cashflows()
        need_exp = self.risk_metrics.requires_exposure_profiles()
        num_ns = len(self.netting_sets)
        for batch in batches:
            with tracing.span("value", family=_family(batch), products=len(batch.products)):
                exp_ns = None
                if isinstance(batch, ExerciseEquityBatch):
                    seg = batch.ns_segments(tables.device)
                    cfs_p, exp_p = batch.evaluate(tables, ctx)
                    if need_cfs:
                        cfs_acc = cfs_acc.index_add(0, seg, cfs_p)
                    if need_exp and exp_p is not None:
                        exp_ns = torch.zeros((exp_p.shape[0], num_ns, exp_p.shape[2]),
                                             dtype=exp_p.dtype, device=exp_p.device).index_add(
                                                 1, seg, exp_p)
                else:
                    if need_cfs:
                        cfs_acc = cfs_acc + batch.segmented_cashflows(tables, num_ns,
                                                                      tables.num_paths)
                    if need_exp:
                        exp_ns = batch.exposure_contributions(tables, ctx)
                if exp_ns is not None:
                    for ns_idx in sorted(set(batch.ns_idx.tolist())):
                        exp_acc[ns_idx] = (exp_ns[:, ns_idx] if exp_acc[ns_idx] is None
                                           else exp_acc[ns_idx] + exp_ns[:, ns_idx])
        return cfs_acc

    def _evaluate_products(self, params, resolved, fits, tables=None):
        """Every product into its netting set: the closed forms of the
        products that skip the simulation summed per metric
        (controller.py:1139-1144), the family batches, the exercise buckets
        reduced by one ``index_add`` each (controller.py:1084-1133), the
        other products one by one."""
        num_ns, n = len(self.netting_sets), self._local(self.num_paths_mainsim)
        cfs_acc = torch.zeros((num_ns, n), dtype=real_dtype(), device=self.device)
        exp_acc: List[Optional[torch.Tensor]] = [None] * num_ns
        zero = torch.zeros((), dtype=real_dtype(), device=self.device)
        analytic = [[zero] * len(self.risk_metrics.metrics) for _ in range(num_ns)]
        has_pathwise = [False] * num_ns
        for product in self.products:
            if product.product_id not in self._analytic_ids:
                has_pathwise[self.product_to_netting_set_idx[product.product_id]] = True
        if self._analytic_ids:
            with tracing.span("value", analytic="closed_form", products=len(self._analytic_ids)):
                for product in self.products:
                    if product.product_id not in self._analytic_ids:
                        continue
                    acc = analytic[self.product_to_netting_set_idx[product.product_id]]
                    for metric_idx, metric in enumerate(self.risk_metrics.metrics):
                        value = metric.evaluate_analytically(product=product, model=self.model,
                                                             params=params)[0][0]
                        acc[metric_idx] = acc[metric_idx] + value
        done = set(self._analytic_ids)
        if self._batches and tables is not None:
            cfs_acc = self._evaluate_batches(fits["batches"], tables, cfs_acc, exp_acc)
            done.update(p.product_id for p in self.products if id(p) in self._batched_ids)
        for products, seg, value in fits["exercise"]:
            with tracing.span("value", exercise_bucket=type(products[0]).__name__,
                              products=len(products)):
                cfs_p, exp_p = value(resolved, tables)
                ns_of = [self.product_to_netting_set_idx[p.product_id] for p in products]
                cfs_acc = self._add_exercise_values(ns_of, seg, cfs_p, exp_p, cfs_acc, exp_acc)
            done.update(p.product_id for p in products)
        cfs_rows = list(cfs_acc.unbind(0))
        for prod_idx, product in enumerate(self.products):
            if product.product_id in done:
                continue
            ns_idx = self.product_to_netting_set_idx[prod_idx]
            with tracing.span("value", product=type(product).__name__, products=1):
                cfs, exposures = self._evaluate_product(product, params, resolved,
                                                        fits["exposure"].get(product.product_id))
                cfs_rows[ns_idx] = cfs_rows[ns_idx] + cfs
                if exposures is not None:
                    exp_acc[ns_idx] = (exposures if exp_acc[ns_idx] is None
                                       else exp_acc[ns_idx] + exposures)
        if self.risk_metrics.requires_exposure_profiles():
            zeros = torch.zeros((len(self.exposure_timeline), n), dtype=real_dtype(),
                                device=self.device)
            exp_acc = [zeros if e is None else e for e in exp_acc]
        nested = []
        for i, ns in enumerate(self.netting_sets):
            with tracing.span("netting", netting_set=i):
                nested.append(self._evaluate_netting_set(i, ns, cfs_rows[i], exp_acc[i], resolved,
                                                         analytic[i], has_pathwise[i]))
        return nested

    @staticmethod
    def _add_exercise_values(ns_of, seg, cfs_p, exp_p, cfs_acc, exp_acc):
        """Exercise products' cashflows [P, N] and exposure profiles [P,
        T_exp, N] (or None) into their netting sets ``ns_of`` (``seg`` on the
        device): the new ``cfs_acc``; ``exp_acc`` is updated in place."""
        cfs_acc = cfs_acc.index_add(0, seg, cfs_p)
        if exp_p is not None:
            exp_ns = torch.zeros((cfs_acc.shape[0],) + exp_p.shape[1:], dtype=exp_p.dtype,
                                 device=exp_p.device).index_add(0, seg, exp_p)
            for ns_idx in sorted(set(ns_of)):
                exp_acc[ns_idx] = (exp_ns[ns_idx] if exp_acc[ns_idx] is None
                                   else exp_acc[ns_idx] + exp_ns[ns_idx])
        return cfs_acc

    def _exposure_ctx(self) -> Optional[ExposureContext]:
        """The batches' exposure context, None for a book without exposure
        profiles (controller.py:1175-1187)."""
        if not self.risk_metrics.requires_exposure_profiles():
            return None
        return ExposureContext(
            exposure_timeline=self.exposure_timeline, num_netting_sets=len(self.netting_sets),
            regression_function=self.regression_function)

    def _no_fits(self):
        """The fits of a run without a pre-simulation: every family batch
        valued by its own executor."""
        return {"exercise": [], "exposure": {}, "batches": self._batches}

    def _fit_regressions(self, params, resolved_pre, tables_pre=None):
        """Every fit on the pre-simulation (controller.py:1413-1432): the
        family batches' fits ("batches": those their own executors value),
        the per-product exposure fits ("exposure") and the exercise executors
        ("exercise"): the torch scans' buckets, the storage kernel's deals
        and the exercise kernel's equity options, each as (products, their
        netting sets on the device, value(resolved, tables) -> (cashflows [P,
        N], exposure profiles [P, T_exp, N] or None) on the main
        simulation)."""
        fits = self._no_fits()
        options = None
        if self._batches:
            options, fits["batches"] = self._book_options.route(self._batches, tables_pre)
            ctx = self._exposure_ctx()
            for batch in fits["batches"]:
                if isinstance(batch, ExerciseEquityBatch):
                    with tracing.span("fit", family=_family(batch), products=len(batch.products)):
                        batch.fit(tables_pre, ctx)
                elif ctx is not None:
                    with tracing.span("fit", family=_family(batch), products=len(batch.products)):
                        batch.fit_exposure(tables_pre, ctx)
        buckets, plain = self._exercise_scan_groups()
        kernel, buckets = self._book_deals.route(buckets, resolved_pre)
        for bucket in buckets:
            with tracing.span("fit", exercise_bucket=type(bucket[0]).__name__,
                              products=len(bucket)):
                coeffs = self._fit_exercise_bucket(bucket, resolved_pre)
            fits["exercise"].append((bucket, self._bucket_seg(bucket), lambda r, t, b=bucket,
                                     c=coeffs: self._evaluate_exercise_bucket(b, c, r)))
        want = self.risk_metrics.requires_exposure_profiles() and len(self.exposure_timeline) > 0
        if kernel is not None:
            with tracing.span("fit", exercise_bucket="Storage", products=len(kernel.products)):
                coeffs = kernel.fit(resolved_pre, self._local(self.num_paths_presim))
            n = self._local(self.num_paths_mainsim)
            fits["exercise"].append((kernel.products, kernel.seg,
                                     lambda r, t, c=coeffs: kernel.value(r, c, n, want)))
        if options is not None:
            with tracing.span("fit", exercise_bucket="ExerciseEquityBatch",
                              products=len(options.products)):
                coeffs = options.fit(tables_pre)
            fits["exercise"].append((options.products, options.seg,
                                     lambda r, t, c=coeffs: options.value(t, c, want)))
        for product in plain:
            with tracing.span("fit", product=type(product).__name__, products=1):
                fits["exposure"][product.product_id] = self._perform_regression_for_product(
                    product, params, resolved_pre)
        return fits

    def _compute(self, params, kernel_noise=None):
        try:
            fits = self._no_fits()
            if self.requires_regression:
                resolved_pre, tables_pre = self._simulate_and_resolve(
                    params, self.num_paths_presim, rng.PHASE_PRESIM, kernel_noise)
                fits = self._fit_regressions(params, resolved_pre, tables_pre)
                del resolved_pre, tables_pre  # free the pre-simulation before the main one
            if self._metric_stream is not None:
                # The main simulation folds its own rows (controller.py:1434-1439).
                return self._metric_stream.run(
                    params, fits, (self.noise_source or {}).get(rng.PHASE_MAINSIM),
                    (self.qmc_shift_source or {}).get(rng.PHASE_MAINSIM))
            resolved = tables = None
            if self._simulates():
                resolved, tables = self._simulate_and_resolve(
                    params, self.num_paths_mainsim, rng.PHASE_MAINSIM, kernel_noise)
            with tracing.span("evaluate", products=len(self.products)):
                return self._evaluate_products(params, resolved, fits, tables)
        finally:
            for batch in self._batches:
                batch.release()

    @staticmethod
    def _flatten(nested):
        values, errors = [], []
        for ns_results in nested:
            for metric_results in ns_results:
                for value, err in metric_results:
                    values.append(value.reshape(()))
                    errors.append(err.reshape(()))
        return torch.stack(values), torch.stack(errors)

    def _result_spec(self):
        """Evaluations per (netting set, metric) (controller.py:2360-2373)."""
        n_dates = len(self.metric_exposure_timeline)
        return [[1 if m.metric_type in _SCALAR_METRICS else n_dates
                 for m in self.risk_metrics.metrics] for _ in self.netting_sets]

    # -- sensitivities --------------------------------------------------------------

    def _resolve_grad_mode(self, params) -> None:
        """Forward mode when the parameter count is at most the value count,
        else reverse (controller.py:1700-1705), unless ``grad_mode`` says."""
        n_values = sum(n for ns in self._result_spec() for n in ns)
        self._grad_mode_resolved = (self.grad_mode if self.grad_mode != "auto" else
                                    "fwd" if len(params) <= n_values else "rev")

    def _pair_fn(self, kernel_noise):
        """params -> (values [V], errors [V]) of one run on the frozen draws."""
        return lambda p: self._flatten(self._compute(p, kernel_noise))

    def _jacobian(self, params, kernel_noise=None):
        """(values [V], errors [V], jacobian [P, V]) of the differentiated run."""
        pair = self._pair_fn(kernel_noise)
        if self._grad_mode_resolved == "rev" and self.path_sharding is not None:
            values, errors, jac = self._jacrev(pair, params)
            return values.detach(), errors.detach(), jac.detach()
        if self._grad_mode_resolved == "rev":
            params = tuple(p.detach().requires_grad_(True) for p in params)
            values, errors = pair(params)
            n, chunk = values.shape[0], self.grad_chunk_size
            eye = torch.eye(n, dtype=values.dtype, device=values.device)
            rows = []
            for start in range(0, n, chunk):
                cotangents = eye[start:start + chunk]
                with tracing.span("sweep", tangents=cotangents.shape[0]):
                    rows.append(torch.stack(torch.autograd.grad(
                        values, params, grad_outputs=cotangents, is_grads_batched=True,
                        retain_graph=start + chunk < n)))
            return values.detach(), errors.detach(), torch.cat(rows, dim=1)
        return self._jacfwd(pair, params)

    def _jacfwd(self, pair, params):
        """Forward mode: ``jvp`` under ``vmap`` over chunks of
        ``grad_chunk_size`` parameter tangents, (values, errors, [P, V])."""
        n_params = len(params)

        def sweep(tangent):
            values, dvalues, errors = jvp(pair, (params,), (tangent,), has_aux=True)
            return values, errors, dvalues

        eye = torch.eye(n_params, dtype=params[0].dtype, device=params[0].device)
        rows, values, errors = [], None, None
        for start in range(0, n_params, self.grad_chunk_size):
            basis = eye[start:start + self.grad_chunk_size]  # [c, P]
            with tracing.span("sweep", tangents=basis.shape[0]):
                values_c, errors_c, rows_c = vmap(sweep)(tuple(basis.unbind(1)))
            values, errors = values_c[0], errors_c[0]
            rows.append(rows_c)
        return values, errors, torch.cat(rows)

    def _jacrev(self, pair, params):
        """Reverse mode as a functional gradient: ``torch.func.vjp`` of the
        values, ``vmap`` over the V unit cotangents, (values, errors, [P, V]).
        Unlike ``torch.autograd.grad`` it composes with the collectives'
        ``vmap`` rules and with an outer ``torch.func.jvp``: the first order
        under a path sharding, and the Hessian rows of the reverse branch.
        The cotangents go ``grad_chunk_size`` at a time.  Under a path
        sharding rank 0 seeds them and the others zeros: each rank's rows
        are its own paths' share, summed over the ranks."""
        values, vjp_fn, errors = vjp(pair, params, has_aux=True)
        cotangents = torch.eye(values.shape[0], dtype=values.dtype, device=values.device)
        sharding = self.path_sharding
        if sharding is not None and sharding.rank != 0:
            cotangents = torch.zeros_like(cotangents)
        chunk = self.grad_chunk_size
        rows = []
        for start in range(0, cotangents.shape[0], chunk):
            block = cotangents[start:start + chunk]
            with tracing.span("sweep", tangents=block.shape[0]):
                rows.append(torch.stack(vmap(vjp_fn)(block)[0]))
        return values, errors, sum_over_ranks(torch.cat(rows, dim=1), sharding)

    def _hessian_row(self, jac_fn, params, j: int):
        """Row j of the Hessian, [P, V]: d jac[i] / d p_j for every i, the
        forward tangent of ``jac_fn`` in direction e_j (controller.py:1652-1671)."""
        with tracing.span("hessian_row", row=j):
            tangent = tuple(torch.zeros_like(p) for p in params)
            tangent[j].fill_(1.0)
            return jvp(jac_fn, (params,), (tangent,))[1].detach()

    def _hessian(self, params, kernel_noise=None):
        """[P, P, V] Hessian, H[i, j] = d jac[i] / d p_j, one row (one outer
        tangent) at a time (controller.py:1673-1683)."""
        pair = self._pair_fn(kernel_noise)
        jacobian = self._jacrev if self._grad_mode_resolved == "rev" else self._jacfwd
        jac_fn = lambda p: jacobian(pair, p)[2]
        rows = [self._hessian_row(jac_fn, params, j) for j in range(len(params))]
        return torch.stack(rows, dim=1)

    # -- public entry point (controller.py:2253-2358) -------------------------------

    def run_simulation(self, profile_dir: Optional[str] = None) -> SimulationResults:
        """Run the pipeline; with ``profile_dir`` the whole run is traced by
        ``torch.profiler`` (host ops, and the card's kernels on a CUDA
        device) and the trace is written there as TensorBoard's
        ``*.pt.trace.json`` (JAX controller.py:2240-2251, a
        ``jax.profiler.trace``), with a range for each of the run's spans
        (tracing.py), which are on for that run.  Tracing changes no value."""
        if profile_dir is None:
            with tracing.span("run", route="kernel" if self._kernel_active else "engine",
                              differentiate=int(self.differentiate)):
                return self._run_simulation_impl()
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        was_on, was_annotating = tracing.enabled(), tracing.annotating()
        tracing.enable(annotate=True)
        try:
            with profile(activities=activities,
                         on_trace_ready=tensorboard_trace_handler(profile_dir)):
                return self.run_simulation()
        finally:
            if was_on:
                tracing.enable(annotate=was_annotating)
            else:
                tracing.disable()

    def _run_simulation_impl(self) -> SimulationResults:
        t0 = time.perf_counter()
        self._ensure_plan()
        params = self.model.initial_params(device=self.device, dtype=real_dtype())

        t1 = time.perf_counter()
        jac = hess_np = None
        if self.differentiate:
            # The frozen kernel draws: one kernel run and one noise recovery
            # per phase, shared by the jacobian and every Hessian row.
            kernel_noise = self._kernel_noise_of(params) if self._kernel_active else None
            self._resolve_grad_mode(params)
            with tracing.span("jacobian", mode=self._grad_mode_resolved):
                values, errors, jac = self._jacobian(params, kernel_noise)
        else:
            with torch.no_grad():
                values, errors = self._flatten(self._compute(params))
        with tracing.span("to_host"):
            jac_np = None if jac is None else jac.detach().cpu().numpy()  # [P, V]
            values_np = values.detach().cpu().numpy()
            errors_np = errors.detach().cpu().numpy()
        t2 = time.perf_counter()
        if self.differentiate and self.requires_higher_order_derivatives:
            hess = self._hessian(params, kernel_noise)
            with tracing.span("to_host"):
                hess_np = hess.cpu().numpy()  # [P, P, V]
        t3 = time.perf_counter()

        with tracing.span("results"):
            results, derivatives, second_derivatives = [], [], []
            flat_idx = 0
            n_params = len(params)
            for ns_spec in self._result_spec():
                ns_results, ns_derivs, ns_hess = [], [], []
                for n_evals in ns_spec:
                    evals, devals, hevals = [], [], []
                    for _ in range(n_evals):
                        evals.append((values_np[flat_idx], errors_np[flat_idx]))
                        if jac_np is not None:
                            devals.append(tuple(jac_np[p, flat_idx] for p in range(n_params)))
                        if hess_np is not None:
                            hevals.append([[hess_np[p1, p2, flat_idx] for p2 in range(n_params)]
                                           for p1 in range(n_params)])
                        flat_idx += 1
                    ns_results.append(evals)
                    ns_derivs.append(devals)
                    ns_hess.append(hevals)
                results.append(ns_results)
                derivatives.append(ns_derivs)
                second_derivatives.append(ns_hess)
            t4 = time.perf_counter()
            out = SimulationResults(
                results,
                derivatives if jac_np is not None else [],
                second_derivatives if hess_np is not None else [],
                netting_set_names=self._make_unique_names(
                    [ns.get_name() for ns in self.netting_sets]),
                metric_names=self._make_unique_names(
                    [m.get_name() for m in self.risk_metrics.metrics]),
                model_param_names=self.model.get_model_param_names(),
            )

        logger.info(
            "Simulation completed for %d netting set(s) and %d product(s) on %s "
            "(%s paths, %s): preprocessing=%.6fs pipeline=%.6fs hessians=%.6fs "
            "postprocessing=%.6fs total=%.6fs",
            len(self.netting_sets), len(self.products), self.device,
            "kernel" if self._kernel_active else "engine",
            ("metric streaming" if self._metric_stream is not None else
             "streaming" if self._emission_schedule is not None else "plane"),
            t1 - t0, t2 - t1, t3 - t2, t4 - t3, t4 - t0,
        )
        return out
