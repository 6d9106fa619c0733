"""SimulationController: the end-to-end Monte Carlo pricing pipeline.

Counterpart of ``montecarlo_risk_engine_tpu/api/controller.py`` for the PV
slice: the constructor checks and the unified simulation timeline, plane-mode
simulation and request resolution, per-product valuation into netting sets
(the JAX ``batch_products=False`` semantics), PV metrics, first-order
sensitivities and the named result assembly.

PyTorch runs the pipeline eagerly on ``device``.  Path generation takes one
of two routes:

  * the Heston-QE path kernel (ops/heston_qe.py) when the book is eligible:
    a Heston model under the QE scheme without the martingale correction,
    the pseudo-random sampler and no antithetic pairs.  Differentiated runs
    use its noise-emitting variant and rebuild the paths from the frozen
    draws under autograd (ops/paths_ad.py).  The kernel's dispatcher, not
    the controller, looks at the device: CUDA launches the kernel, the CPU
    runs its plain version.
  * otherwise the engine (engine/engine.py), on any device.

``use_kernel``: "auto" takes the kernel whenever eligible, True requires it
(an ineligible book raises), False forces the engine.  An injected
``noise_source`` ({phase: counter -> (z, u)}, the test seam that feeds the
JAX engine's own draws) forces the engine too.

Sensitivities: reverse mode.  One recorded forward pass, then one batched
backward over the V metric values (``is_grads_batched``): the values share
every path, the graph holds the draws once, and V (one PV per netting set)
and P (7 Heston parameters) are of the same order, so reverse mode costs one
forward where forward mode would repeat the whole pipeline per parameter.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from montecarlo_risk_engine_tpu_torch import rng
from montecarlo_risk_engine_tpu_torch.api.results import SimulationResults
from montecarlo_risk_engine_tpu_torch.config import SimulationScheme, real_dtype, resolve_device
from montecarlo_risk_engine_tpu_torch.engine.engine import simulate_paths
from montecarlo_risk_engine_tpu_torch.metrics.metrics import EvaluationType, RiskMetrics
from montecarlo_risk_engine_tpu_torch.models.base import Model
from montecarlo_risk_engine_tpu_torch.ops.paths_ad import dense_timeline, emitted_noise_fns
from montecarlo_risk_engine_tpu_torch.products.base import Product
from montecarlo_risk_engine_tpu_torch.products.netting_set import NettingSet
from montecarlo_risk_engine_tpu_torch.requests import RequestPlan

logger = logging.getLogger(__name__)


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
        root_seed: int = 0,
        antithetic: bool = False,
        sampler: str = "pseudo",
        use_kernel: object = "auto",
        device=None,
        noise_source: Optional[Dict[int, Callable]] = None,
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

        if risk_metrics.requires_exposure_profiles():
            raise NotImplementedError(
                "exposure metrics (CE/EPE/ENE/EEPE/PFE/CVA) are not ported yet; "
                "this controller values PV books"
            )
        if any(m.evaluation_type == EvaluationType.ANALYTICAL for m in risk_metrics.metrics):
            raise NotImplementedError(
                "analytic evaluation comes with the Black-Scholes model; no model "
                "of the port has a closed-form PV yet"
            )

        self.model = model
        self.num_paths_presim = int(num_paths_presim)
        self.num_paths_mainsim = int(num_paths_mainsim)
        self.num_steps = int(num_steps)
        self.simulation_scheme = simulation_scheme
        self.differentiate = bool(differentiate)
        self.root_seed = int(root_seed)
        self.antithetic = bool(antithetic)
        if sampler not in ("pseudo", "sobol"):
            raise ValueError("sampler must be 'pseudo' or 'sobol'")
        if sampler == "sobol" and antithetic:
            raise ValueError("sampler='sobol' is incompatible with antithetic sampling")
        self.sampler = sampler
        if use_kernel not in ("auto", True, False):
            raise ValueError("use_kernel must be 'auto', True or False")
        self.use_kernel = use_kernel
        self.device = resolve_device(device)
        self.noise_source = dict(noise_source) if noise_source else None

        for prod_id, prod in enumerate(self.products):
            prod.product_id = prod_id

        if differentiate:
            self.model.requires_grad()

        # Unified simulation timeline (reference controller.py:142-145).
        prod_times = {t for prod in self.products for t in prod.modeling_timeline}
        self.simulation_timeline: Tuple[float, ...] = tuple(sorted(prod_times))

        regression = [type(p).__name__ for p in self.products if len(p.regression_timeline) > 0]
        if regression:
            raise NotImplementedError(
                f"least-squares regression (early exercise) is not ported yet: {sorted(set(regression))}"
            )

        self._kernel_active = self._decide_kernel()
        self._plan: Optional[RequestPlan] = None

    # -- setup helpers ----------------------------------------------------------

    def _decide_kernel(self) -> bool:
        """The plain rule that replaces the JAX package's ``_decide_pallas``."""
        eligible = (
            self.model.supports_kernel_paths(self.simulation_scheme)
            and self.sampler == "pseudo"
            and not self.antithetic
        )
        if self.use_kernel is True:
            if not eligible:
                raise ValueError(
                    "use_kernel=True but the book is not kernel-eligible: the path kernel "
                    "needs a Heston model under QE without the martingale correction, "
                    "sampler='pseudo' and antithetic=False"
                )
            if self.noise_source is not None:
                raise ValueError("use_kernel=True contradicts an injected noise_source")
            return True
        if self.use_kernel is False or self.noise_source is not None:
            return False
        return eligible

    @staticmethod
    def _make_unique_names(base_names: List[str]) -> List[str]:
        counts: Dict[str, int] = defaultdict(int)
        unique = []
        for name in base_names:
            counts[name] += 1
            unique.append(name if counts[name] == 1 else f"{name}#{counts[name]}")
        return unique

    # -- simulation -------------------------------------------------------------

    def _simulate_and_resolve(self, params, num_paths: int, phase: int):
        """One simulation pass -> resolved handle lists over the [T, N, D]
        state plane."""
        if self._kernel_active:
            if self.differentiate:
                _, noise_fn, recon_fn = self._kernel_ad_fns(num_paths, phase)
                states = recon_fn(params, noise_fn(params))
            else:
                states = self.model.kernel_paths(
                    params, self.simulation_scheme, self.simulation_timeline,
                    num_paths, self.num_steps, seed=self.root_seed, phase=phase,
                ).to(real_dtype())
        else:
            states = simulate_paths(
                self.model, params, self.simulation_scheme, self.simulation_timeline,
                num_paths, self.num_steps, phase, root_seed=self.root_seed,
                noise_source=(self.noise_source or {}).get(phase),
                antithetic=self.antithetic, sampler=self.sampler, device=self.device,
            )
        return self._plan.resolve_requests(params, states)

    def _kernel_ad_fns(self, num_paths: int, phase: int):
        """(forward_coarse, noise_fn, recon_fn) of the emitted-noise AD path."""
        dense, _ = dense_timeline(self.model.calibration_date, self.simulation_timeline,
                                  self.num_steps)

        def noise_forward(p):
            return self.model.kernel_paths_with_noise(
                p, self.simulation_scheme, dense, num_paths,
                seed=self.root_seed, phase=phase,
            )

        return emitted_noise_fns(self.model, self.simulation_scheme, self.simulation_timeline,
                                 num_paths, self.num_steps, noise_forward)

    # -- valuation (reference controller.py:385-604) -------------------------------

    def _evaluate_product(self, product: Product, params, resolved) -> torch.Tensor:
        """Numeraire-deflated cashflows [N] summed over the product's dates."""
        num_paths = self.num_paths_mainsim
        state_matrix = torch.full((num_paths, 1), product.get_initial_state(),
                                  dtype=torch.long, device=self.device)
        cfs = torch.zeros((num_paths,), dtype=real_dtype(), device=self.device)
        for t_idx in range(len(product.product_timeline)):
            state_matrix, new_cfs = product.compute_normalized_cashflows(
                t_idx, self.model, params, resolved, None, state_matrix,
            )
            cfs = cfs + new_cfs[:, 0]
        return cfs

    def _evaluate_netting_set(self, netting_set, cfs, resolved):
        return [
            metric.evaluate(cfs=cfs, resolved_requests=resolved,
                            netting_set=netting_set, model=self.model)
            for metric in self.risk_metrics.metrics
        ]

    def _evaluate_products(self, params, resolved):
        cfs_acc = [torch.zeros((self.num_paths_mainsim,), dtype=real_dtype(), device=self.device)
                   for _ in self.netting_sets]
        for prod_idx, product in enumerate(self.products):
            ns_idx = self.product_to_netting_set_idx[prod_idx]
            cfs_acc[ns_idx] = cfs_acc[ns_idx] + self._evaluate_product(product, params, resolved)
        return [
            self._evaluate_netting_set(ns, cfs_acc[i], resolved)
            for i, ns in enumerate(self.netting_sets)
        ]

    def _compute(self, params):
        resolved = self._simulate_and_resolve(params, self.num_paths_mainsim, rng.PHASE_MAINSIM)
        return self._evaluate_products(params, resolved)

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
        # PV-only books: one evaluation per metric and netting set.
        return [[1 for _ in self.risk_metrics.metrics] for _ in self.netting_sets]

    # -- public entry point (reference controller.py:663-709) -------------------------

    def run_simulation(self) -> SimulationResults:
        t0 = time.perf_counter()
        if self._plan is None:
            self._plan = RequestPlan(self.model)
            self._plan.collect_and_index_requests(
                self.products, self.simulation_timeline, {}, (),
            )
        params = self.model.initial_params(device=self.device, dtype=real_dtype())

        t1 = time.perf_counter()
        grads = None
        if self.differentiate:
            params = tuple(p.requires_grad_(True) for p in params)
            values, errors = self._flatten(self._compute(params))
            t2 = time.perf_counter()
            cotangents = torch.eye(values.shape[0], dtype=values.dtype, device=values.device)
            grads = torch.autograd.grad(values, params, grad_outputs=cotangents,
                                        is_grads_batched=True)
            grads_np = [g.detach().cpu().numpy() for g in grads]  # per param: [V]
        else:
            with torch.no_grad():
                values, errors = self._flatten(self._compute(params))
            t2 = time.perf_counter()
        values_np = values.detach().cpu().numpy()
        errors_np = errors.detach().cpu().numpy()
        t3 = time.perf_counter()

        results, derivatives = [], []
        flat_idx = 0
        n_params = len(params)
        for ns_spec in self._result_spec():
            ns_results, ns_derivs = [], []
            for n_evals in ns_spec:
                evals, devals = [], []
                for _ in range(n_evals):
                    evals.append((values_np[flat_idx], errors_np[flat_idx]))
                    if grads is not None:
                        devals.append(tuple(grads_np[p][flat_idx] for p in range(n_params)))
                    flat_idx += 1
                ns_results.append(evals)
                ns_derivs.append(devals)
            results.append(ns_results)
            derivatives.append(ns_derivs)

        t4 = time.perf_counter()
        logger.info(
            "Simulation completed for %d netting set(s) and %d product(s) on %s "
            "(%s paths): preprocessing=%.6fs pipeline=%.6fs differentiation=%.6fs "
            "postprocessing=%.6fs total=%.6fs",
            len(self.netting_sets), len(self.products), self.device,
            "kernel" if self._kernel_active else "engine",
            t1 - t0, t2 - t1, t3 - t2, t4 - t3, t4 - t0,
        )

        return SimulationResults(
            results,
            derivatives if grads is not None else [],
            [],
            netting_set_names=self._make_unique_names([ns.get_name() for ns in self.netting_sets]),
            metric_names=self._make_unique_names([m.get_name() for m in self.risk_metrics.metrics]),
            model_param_names=self.model.get_model_param_names(),
        )
