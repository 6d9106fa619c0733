"""Family-batched product executors for large books.

Counterpart of ``montecarlo_risk_engine_tpu/api/batching.py``.  The
controller's per-product path values a book one product at a time, about ten
small ops each; a 50,000-product book then spends its run dispatching them.
Products are grouped by family and static signature and valued as one
table-driven computation per group:

  * terminal stateless payoffs (European, binary, basket, Asian and barrier
    options on spot observables) become one vectorised payoff over [P, ...]
    tables; a large European (binary) book becomes sums of hinges (ramps),
    one per (netting set, asset, date, sign) group, evaluated from sorted
    strikes and prefix sums;
  * Bermudan, American and FlexiCall exercise machines on an equity run one
    loop over merged exercise and exposure events with a product-batched
    carry [P, N, S]: batched Gram solves for the LSM fit, a vectorised
    decision for the valuation (on the card, where its route engages, the
    controller hands every such batch of a book to one kernel launch a
    phase instead, ops/exercise_scan.py, on the rows these loops read);
  * bonds and swaps collapse into fixed and floating event tables.

Every table (strikes, signs, time indices, netting-set indices) is built on
the host once per batch and enters the device once per device and dtype
(``_const``); no batch reads a device tensor back to the host.

Exposure profiles are batched too: terminal products regress their
strictly-future cashflow on the explanatory spot with one Gram matrix per
(asset, exposure date), shared by every product on that asset; the exercise
products emit their realized-state continuations.  Netting happens inside
the per-asset and per-date loops, so nothing of shape [T_exp, P, N] is
built for large P.

Every path-axis sum (the Gram power sums, the regressions' right-hand
sides, the exercise fits) is a ``fixed_tree_sum`` (JAX batching.py:304-372,
944-963, 1286), never a ``torch.sum`` or a matrix product, whose reduction
order a library picks: under a path sharding (the tables' ``sharding``) a
rank sums its own paths and the ranks' partials add in a fixed tree, so a
fit has the same bits on any number of ranks.  Each fit gathers its partials
once.  Scatter-adds are out-of-place ``index_add`` and every
solve factors and solves in two steps (``lu_factor_ex``, ``lu_solve``), so
the executors run under ``torch.func`` transforms to every order.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch import tracing
from montecarlo_risk_engine_tpu_torch.config import real_dtype
from montecarlo_risk_engine_tpu_torch.metrics.metrics import fixed_tree_sum, global_count
from montecarlo_risk_engine_tpu_torch.models.black_scholes_multi import BlackScholesMulti
from montecarlo_risk_engine_tpu_torch.ops.gather import RowSelection
from montecarlo_risk_engine_tpu_torch.ops.noise import matmul_t
from montecarlo_risk_engine_tpu_torch.parallel.collectives import sum_over_ranks
from montecarlo_risk_engine_tpu_torch.products.asian_option import AsianAveragingType, AsianOption
from montecarlo_risk_engine_tpu_torch.products.barrier_option import (
    BarrierOption,
    BarrierOptionType,
)
from montecarlo_risk_engine_tpu_torch.products.base import OptionType
from montecarlo_risk_engine_tpu_torch.products.basket_option import BasketOption, BasketOptionType
from montecarlo_risk_engine_tpu_torch.products.bermudan_option import BermudanOption
from montecarlo_risk_engine_tpu_torch.products.binary_option import BinaryOption
from montecarlo_risk_engine_tpu_torch.products.bond import Bond
from montecarlo_risk_engine_tpu_torch.products.equity import Equity
from montecarlo_risk_engine_tpu_torch.products.european_option import EuropeanOption
from montecarlo_risk_engine_tpu_torch.products.flexicall import FlexiCall
from montecarlo_risk_engine_tpu_torch.products.swap import InterestRateSwap, IRSType
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequestType
from montecarlo_risk_engine_tpu_torch.utils.maths import compute_degree_of_truth
from montecarlo_risk_engine_tpu_torch.utils.regression import fit_least_squares


def _itemsize() -> int:
    return torch.finfo(real_dtype()).bits // 8


def _segment_sum(x, seg, num_segments: int, out=None):
    """``out`` (zeros by default) plus the rows of ``x`` summed by segment
    along the first axis, ``jax.ops.segment_sum``'s counterpart."""
    if out is None:
        out = torch.zeros((num_segments,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add(0, seg, x)


def _solve(gram, rhs):
    """``gram^-1 rhs`` by LU factor and solve: ``torch.linalg.solve``'s own
    forward-mode rule is wrong under a second forward tangent."""
    lu, pivots, _ = torch.linalg.lu_factor_ex(gram)
    return torch.linalg.lu_solve(lu, pivots, rhs)


class ObservableTables:
    """Lazy per-run tables of resolved observables keyed by (kind, asset).

    One ``resolve_request_rows`` call per (asset, unique time set), shared by
    every batch in the book, on the state plane of one simulation phase
    (this rank's ``num_paths`` paths of a run sharded by ``sharding``).
    """

    def __init__(self, model, params, states, num_paths, sharding=None):
        self.model = model
        self.params = params
        self.states = states
        self.num_paths = num_paths
        self.sharding = sharding
        self.device = (states if isinstance(states, torch.Tensor) else states[0]).device
        self._cache: Dict[Tuple, torch.Tensor] = {}

    def _resolve(self, kind, asset_id, tidx, times1, times2):
        as_t = lambda t: torch.as_tensor(np.asarray(t, dtype=np.float64), dtype=real_dtype(),
                                         device=self.device)
        out = self.model.resolve_request_rows(self.params, kind, asset_id, as_t(times1),
                                              as_t(times2), RowSelection(self.states, tidx))
        if out.dim() == 1:
            out = out[:, None].expand(out.shape[0], self.num_paths)
        return out

    def rows(self, kind, asset_id: str, tidx: np.ndarray, times: np.ndarray):
        """Resolved observable rows [len(tidx), N] for (kind, asset)."""
        tidx = np.asarray(tidx)
        key = (kind, asset_id, tuple(tidx.tolist()), tuple(np.round(times, 12).tolist()))
        if key not in self._cache:
            self._cache[key] = self._resolve(kind, asset_id, tidx, times, np.zeros(len(tidx)))
        return self._cache[key]

    def request_rows(self, kind, asset_id, tidx, times1, times2):
        """Resolved rows [len(tidx), N] for explicit (t1, t2) requests (LIBOR
        fixings), where a (time, asset, kind) lookup would be ambiguous."""
        tidx = np.asarray(tidx)
        key = (kind, asset_id, tuple(tidx.tolist()),
               tuple(np.round(np.asarray(times1), 12).tolist()),
               tuple(np.round(np.asarray(times2), 12).tolist()))
        if key not in self._cache:
            self._cache[key] = self._resolve(kind, asset_id, tidx, times1, times2)
        return self._cache[key]


class EmittedTables:
    """:class:`ObservableTables` backed by the streaming engine's emissions
    (batching.py:108-187).  No state plane exists in streaming mode: every
    observable was resolved inside the path loop, so a query gathers rows of
    the group's [T*K, N] emission tensor."""

    def __init__(self, plan, schedule, emissions, params, num_paths, sharding=None):
        self.plan = plan
        self.schedule = schedule
        self.emissions = emissions
        self.params = params
        self.num_paths = num_paths
        self.sharding = sharding
        self.device = next((e.device for e in emissions), torch.device("cpu"))
        self._cache: Dict[Tuple, torch.Tensor] = {}
        self._handles: Optional[Dict[Tuple, int]] = None

    def _gather(self, handles) -> torch.Tensor:
        locs = [self.schedule.handle_loc[int(h)] for h in handles]
        if len({g for g, _ in locs}) != 1:
            raise ValueError("one (kind, asset) query spans several emission groups")
        flat = self.emissions[locs[0][0]]
        out = flat.index_select(0, torch.as_tensor([r for _, r in locs], device=flat.device))
        if out.dim() == 1:
            out = out[:, None].expand(out.shape[0], self.num_paths)
        return out

    def rows(self, kind, asset_id: str, tidx: np.ndarray, times: np.ndarray):
        """Resolved observable rows [len(tidx), N] for (kind, asset)."""
        tidx = [int(t) for t in np.asarray(tidx).tolist()]
        key = (kind, asset_id, tuple(tidx))
        if key not in self._cache:
            lookup, handles = self.schedule.kind_lookup, []
            for t in tidx:
                lkey = (t, asset_id, kind)
                if lkey not in lookup:
                    if lkey in self.schedule.ambiguous_kinds:
                        raise KeyError(
                            f"ambiguous streaming emission for {kind} on '{asset_id}' at time "
                            f"index {t}: several requests share this (time, asset, kind) with "
                            "different (t1, t2) parameters, so a kind-level query cannot pick "
                            "one; query by request times instead")
                    raise KeyError(f"streaming emission missing for {kind} on '{asset_id}' at "
                                   f"time index {t}: request not registered in the plan")
                handles.append(lookup[lkey])
            self._cache[key] = self._gather(handles)
        return self._cache[key]

    def request_rows(self, kind, asset_id, tidx, times1, times2):
        """Rows [len(tidx), N] of explicit (t1, t2) requests (LIBOR fixings),
        found by their full identity in the plan, so a (time, asset, kind)
        that several requests share is no ambiguity here."""
        if self._handles is None:
            self._handles = {
                (t_idx, a, req.request_type, 0.0 if req.time1 is None else round(req.time1, 12),
                 0.0 if req.time2 is None else round(req.time2, 12)): req.handle
                for (t_idx, a), reqs in self.plan.atomic_by_label.items() for req in reqs}
        handles = [self._handles[(int(t), asset_id, kind, round(float(t1), 12),
                                  round(float(t2), 12))]
                   for t, t1, t2 in zip(np.asarray(tidx).tolist(), np.asarray(times1).tolist(),
                                        np.asarray(times2).tolist())]
        key = (kind, asset_id, tuple(handles))
        if key not in self._cache:
            self._cache[key] = self._gather(handles)
        return self._cache[key]


def _unique_rows(tidx_flat: np.ndarray, times_flat: np.ndarray):
    uniq, inverse = np.unique(tidx_flat, return_inverse=True)
    time_for_uniq = np.zeros(len(uniq))
    time_for_uniq[inverse] = times_flat
    return uniq, inverse, time_for_uniq


class ExposureContext:
    """Static exposure-pipeline data shared by all batches in a run."""

    def __init__(self, exposure_timeline, num_netting_sets, regression_function):
        self.exposure_timeline = tuple(exposure_timeline)  # internal timeline
        self.num_netting_sets = num_netting_sets
        self.regression_function = regression_function


class TerminalBatch:
    """Shared machinery for stateless terminal-payoff families."""

    # Target size of the dense [products, paths] cashflow temp per chunk: a
    # 10k-option x 1M-path book would otherwise build an 80 GB payoff matrix
    # before the per-netting-set reduction.
    CASHFLOW_CHUNK_BYTES = 1 << 30

    def __init__(self, products: Sequence, ns_idx: np.ndarray, time_to_index):
        self.products = list(products)
        self.ns_idx = np.asarray(ns_idx, dtype=np.int64)
        self.time_to_index = time_to_index
        self._exp_coeffs: Optional[Dict[str, torch.Tensor]] = None  # asset -> [T_exp, Pa, deg]
        self._host: Dict[str, object] = {}
        self._device: Dict[Tuple, torch.Tensor] = {}

    def _table(self, name: str, build):
        """A host table of this batch, built once."""
        if name not in self._host:
            self._host[name] = build()
        return self._host[name]

    def _const(self, name: str, build, device, dtype=None):
        """A host table as a device constant, uploaded once per device and
        dtype (``dtype`` None: the working float dtype)."""
        dtype = dtype or real_dtype()
        key = (name, dtype, device)
        if key not in self._device:
            self._device[key] = torch.as_tensor(np.asarray(self._table(name, build)),
                                                dtype=dtype, device=device)
        return self._device[key]

    def release(self) -> None:
        """Drop the run's fitted coefficients (and the graph they hold)."""
        self._exp_coeffs = None

    def maturities(self) -> np.ndarray:
        """Per-product cashflow date (terminal families have exactly one)."""
        return np.array([p.product_timeline[-1] for p in self.products])

    def _slice(self, lo: int, hi: int) -> "TerminalBatch":
        return self._subset(range(lo, hi))

    def _subset(self, rows) -> "TerminalBatch":
        rows = list(rows)
        sub = type(self)([self.products[i] for i in rows],
                         self.ns_idx[np.asarray(rows, dtype=int)], self.time_to_index)
        # analytic fast-path flags (EuropeanEquityBatch) ride along
        for attr in ("use_analytic_exposure", "analytic_model"):
            if hasattr(self, attr):
                setattr(sub, attr, getattr(self, attr))
        return sub

    def _cashflow_chunk(self, num_paths: int) -> int:
        return max(1, self.CASHFLOW_CHUNK_BYTES // max(1, num_paths * _itemsize()))

    def ns_segments(self, device):
        """The products' netting-set indices [P] on ``device``."""
        return self._const("ns_idx", lambda: self.ns_idx, device, torch.long)

    def segmented_cashflows(self, tables, n_ns: int, num_paths: int):
        """Per-netting-set pathwise cashflows [n_ns, N], accumulating the
        payoff matrix in product chunks so the dense [P, N] temp stays under
        CASHFLOW_CHUNK_BYTES (each chunk adds into the running total in
        product order, so the chunked sum equals the dense one)."""
        chunk = self._cashflow_chunk(num_paths)
        num_products = len(self.products)
        if num_products <= chunk:
            return _segment_sum(self.cashflows(tables), self.ns_segments(tables.device), n_ns)
        total = torch.zeros((n_ns, num_paths), dtype=real_dtype(), device=tables.device)
        for lo in range(0, num_products, chunk):
            sub = self._table(f"slice:{chunk}:{lo}",
                              lambda: self._slice(lo, min(lo + chunk, num_products)))
            total = _segment_sum(sub.cashflows(tables), sub.ns_segments(tables.device), n_ns,
                                 total)
        return total

    def explanatory_assets(self):
        """Per-product explanatory asset: the first asset id (quirk Q9,
        single-factor regression)."""
        return [p.asset_ids[0] for p in self.products]

    def _by_asset(self):
        """{explanatory asset: product rows} in first-appearance order."""
        def build():
            out = defaultdict(list)
            for p_idx, a in enumerate(self.explanatory_assets()):
                out[a].append(p_idx)
            return {a: np.asarray(rows, dtype=np.int64) for a, rows in out.items()}
        return self._table("by_asset", build)

    def _exposure_grid_obs(self, tables: ObservableTables, ctx: ExposureContext, asset):
        """(explanatory [T_exp, N], numeraire [T_exp, N]) on the exposure grid.

        The [T_exp, N, deg] basis is never built: fit_exposure and
        exposure_contributions take running powers and Horner steps of the
        raw explanatory, keeping the peak state [T, N]-sized."""
        t_grid = np.array(ctx.exposure_timeline)
        tidx = np.array([self.time_to_index[t] for t in t_grid])
        expl = tables.rows(AtomicRequestType.SPOT, asset, tidx, t_grid)
        numeraire = tables.rows(AtomicRequestType.NUMERAIRE, "numeraire", tidx, t_grid)
        return expl, numeraire

    def _exposure_gram(self, expl, deg: int, sharding=None):
        """(gram [T, deg, deg], col_scale [T, deg], s1 [T]) of the
        exposure-grid normal equations.

        The Gram entries are monomial power sums of the RMS-normalised
        explanatory y = x / s1, s1 = sqrt(mean x^2), accumulated with one
        running power over a chunk of dates, so every summand is O(1) and no
        temp outgrows [Tc, N]; the implied column equilibration s1^d is
        undone on the solved coefficients.  A ridge of 1e-10 (float64) or
        1e-4 (float32) of the mean diagonal keeps a constant explanatory
        (t = 0) solvable.  ``sharding``: N is this rank's share of the
        paths."""
        num_dates, n_local = expl.shape
        n_paths = global_count(n_local, sharding)
        s1 = torch.clamp(torch.sqrt(fixed_tree_sum(expl * expl, 1, sharding) / n_paths),
                         min=1e-30)                                       # [T]
        t_chunk = self._date_chunk((2 * deg - 2) * n_local)
        power = [torch.full((1, num_dates), float(n_paths), dtype=expl.dtype, device=expl.device)]
        if deg > 1:
            sums = []
            for lo in range(0, num_dates, t_chunk):
                y = expl[lo:lo + t_chunk] / s1[lo:lo + t_chunk, None]
                pw, powers = torch.ones_like(y), []
                for _ in range(2 * deg - 2):
                    pw = pw * y
                    powers.append(pw)
                sums.append(fixed_tree_sum(torch.stack(powers), -1))   # one tree sum a chunk
            power.append(sum_over_ranks(torch.cat(sums, dim=1), sharding))
        power_sums = torch.cat(power)                                    # [2 deg - 1, T]
        col_scale = s1[:, None] ** torch.arange(deg, dtype=s1.dtype, device=s1.device)[None, :]
        hankel = torch.as_tensor(np.add.outer(np.arange(deg), np.arange(deg)), device=s1.device)
        gram = power_sums[hankel].permute(2, 0, 1)                       # [T, deg, deg]
        ridge_rel = 1e-10 if torch.finfo(gram.dtype).bits >= 64 else 1e-4
        scale = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1) / deg
        eye = torch.eye(deg, dtype=gram.dtype, device=gram.device)
        return gram + (ridge_rel * scale + 1e-30)[:, None, None] * eye, col_scale, s1

    def _date_chunk(self, per_date_elements: int) -> int:
        """Dates per chunk of a [dates, ...] temp of ``per_date_elements``
        elements, a quarter of CASHFLOW_CHUNK_BYTES."""
        return max(1, (self.CASHFLOW_CHUNK_BYTES // 4) // max(1, per_date_elements * _itemsize()))

    @staticmethod
    def _weighted_basis(numeraire, expl, s1, lo: int, hi: int, deg: int):
        """[hi - lo, deg, N]: numeraire * (expl / s1)^d on dates lo .. hi - 1."""
        y = expl[lo:hi] / s1[lo:hi, None]
        w = numeraire[lo:hi]
        cols = [w]
        for _ in range(1, deg):
            w = w * y
            cols.append(w)
        return torch.stack(cols, dim=1)

    def fit_exposure(self, tables: ObservableTables, ctx: ExposureContext) -> None:
        """Regress the masked terminal cashflows on the explanatory spot: one
        Gram per (asset, date), shared by every product on the asset, and one
        batched solve over the grid.  The right-hand sides rhs[t, d, p] =
        sum_n y^d num[t, n] cf[p, n] are tree sums over chunks of products and
        of dates, the [Tc, Pc, N] temp bounded by ``_date_chunk``."""
        deg = ctx.regression_function.get_degree()
        t_grid = np.array(ctx.exposure_timeline)
        chunk = self._cashflow_chunk(tables.num_paths)
        maturities = self.maturities()
        self._exp_coeffs = {}
        for a, p_rows in self._by_asset().items():
            expl, numeraire = self._exposure_grid_obs(tables, ctx, a)
            gram, col_scale, s1 = self._exposure_gram(expl, deg, tables.sharding)
            cf_chunks = [self._table(f"subset:{a}:{chunk}:{lo}", lambda: self._subset(
                p_rows[lo:lo + chunk])).cashflows(tables) for lo in range(0, len(p_rows), chunk)]
            blocks = []
            for cf_c in cf_chunks:
                # rhs[t, d, p] = sum_n w[t, d, n] cf[p, n], a tree sum over
                # [Tc, deg, Pc, N] products, Tc dates at a time
                t_chunk = self._date_chunk(deg * cf_c.shape[0] * expl.shape[1])
                per_t = []
                for lo in range(0, len(t_grid), t_chunk):
                    w = self._weighted_basis(numeraire, expl, s1, lo, lo + t_chunk, deg)
                    per_t.append(fixed_tree_sum(w[:, :, None, :] * cf_c[None, None], -1))
                blocks.append(torch.cat(per_t))                            # [T, deg, Pc]
            rhs = sum_over_ranks(torch.cat(blocks, dim=-1), tables.sharding)  # [T, deg, Pa]
            mask = self._const(f"maturity_mask:{a}", lambda: (
                maturities[p_rows][None, :] > t_grid[:, None]), tables.device)
            sol = _solve(gram, rhs * mask[:, None, :]) / col_scale[:, :, None]
            self._exp_coeffs[a] = sol.transpose(1, 2)                      # [T, Pa, deg]

    def exposure_contributions(self, tables: ObservableTables, ctx: ExposureContext):
        """Per-netting-set exposure profiles [T_exp, n_ns, N].

        Exposure is linear in the coefficients, so products collapse to their
        netting set before the basis product, and the Horner evaluation runs
        in date chunks that bound the live [Tc, n_ns, N] slice."""
        n_ns = ctx.num_netting_sets
        total = torch.zeros((len(ctx.exposure_timeline), n_ns, tables.num_paths),
                            dtype=real_dtype(), device=tables.device)
        for a, p_rows in self._by_asset().items():
            expl, numeraire = self._exposure_grid_obs(tables, ctx, a)
            coeffs = self._exp_coeffs[a]                                   # [T, Pa, deg]
            seg = self._const(f"ns_idx:{a}", lambda: self.ns_idx[p_rows], tables.device,
                              torch.long)
            coeffs_ns = torch.zeros((coeffs.shape[0], n_ns, coeffs.shape[2]), dtype=coeffs.dtype,
                                    device=coeffs.device).index_add(1, seg, coeffs)
            deg, num_dates = coeffs_ns.shape[-1], coeffs_ns.shape[0]
            t_chunk = min(num_dates, self._date_chunk(n_ns * expl.shape[1]))
            pieces = []
            for lo in range(0, num_dates, t_chunk):
                c_c, e_c = coeffs_ns[lo:lo + t_chunk], expl[lo:lo + t_chunk]
                acc = c_c[:, :, deg - 1, None].expand(c_c.shape[:2] + (e_c.shape[1],))
                for d in range(deg - 2, -1, -1):
                    acc = acc * e_c[:, None, :] + c_c[:, :, d, None]
                pieces.append(acc / numeraire[lo:lo + t_chunk, None, :])
            total = total + torch.cat(pieces, dim=0)
        return total

    def _spot_plan(self, asset_ids, tidx_mat, times_mat, name: str):
        """(per asset (asset, unique time indices, their times), the rows
        [P, O] of the per-product observations in those tables stacked),
        cached under ``name``."""
        def build():
            out_rows = np.empty(tidx_mat.shape, dtype=np.int64)
            plan, offset = [], 0
            order = defaultdict(list)
            for p, a in enumerate(asset_ids):
                order[a].append(p)
            for a, rows_p in order.items():
                rows_p = np.array(rows_p)
                uniq, inverse, time_u = _unique_rows(tidx_mat[rows_p].ravel(),
                                                     times_mat[rows_p].ravel())
                plan.append((a, uniq, time_u))
                out_rows[rows_p] = (offset + inverse).reshape(len(rows_p), -1)
                offset += len(uniq)
            return plan, out_rows

        return self._table(name, build)

    def _spot_matrix(self, tables: ObservableTables, asset_ids, tidx_mat, times_mat,
                     name: str = "spots"):
        """Spots of per-product observation rows, [P, O, N]: one resolved
        table per asset over its unique dates, then one gather.  ``name``
        keys the cached host index tables (one per call site)."""
        plan, out_rows = self._spot_plan(asset_ids, tidx_mat, times_mat, name)
        full = torch.cat([tables.rows(AtomicRequestType.SPOT, a, uniq, time_u)
                          for a, uniq, time_u in plan], dim=0)
        index = self._const(f"{name}:rows", lambda: out_rows.ravel(), tables.device, torch.long)
        return full.index_select(0, index).reshape(out_rows.shape + (full.shape[-1],))

    def _numeraires(self, tables: ObservableTables, tidx: np.ndarray, times: np.ndarray,
                    name: str = "numeraires"):
        """Numeraire rows [len(tidx), N] of per-row (time index, time)."""
        uniq, inverse, time_u = self._table(name, lambda: _unique_rows(tidx, times))
        table = tables.rows(AtomicRequestType.NUMERAIRE, "numeraire", uniq, time_u)
        return table.index_select(0, self._const(f"{name}:rows", lambda: inverse, tables.device,
                                                 torch.long))


class EuropeanEquityBatch(TerminalBatch):
    """All EuropeanOption-on-Equity products in one payoff computation."""

    # Set by the controller when the analytic discounted-exposure fast path
    # applies (a Black-Scholes-family model, metrics in PV / EPE / ENE / CE /
    # EEPE / PFE).
    use_analytic_exposure = False
    analytic_model = None

    # Use the sorted-strike hinge-sum path once the book is this many times
    # larger than its (asset, date, sign, netting-set) group count.
    HINGE_SUM_MIN_RATIO = 4

    @staticmethod
    def accepts(product) -> bool:
        return isinstance(product, EuropeanOption) and isinstance(product.underlying, Equity)

    @staticmethod
    def group_key(product):
        return ("european_equity",)

    def cashflows(self, tables: ObservableTables):
        def build():
            prods = self.products
            return dict(
                tidx=np.array([self.time_to_index[p.exercise_date] for p in prods]),
                times=np.array([p.exercise_date for p in prods]),
                assets=[p.underlying.get_asset_id() for p in prods],
                strikes=np.array([p.strike for p in prods])[:, None],
                signs=np.array([1.0 if p.option_type == OptionType.CALL else -1.0
                                for p in prods])[:, None])
        h = self._table("terms", build)
        spots = self._spot_matrix(tables, h["assets"], h["tidx"][:, None],
                                  h["times"][:, None])[:, 0, :]
        numeraire = self._numeraires(tables, h["tidx"], h["times"])
        strikes = self._const("strikes", lambda: h["strikes"], tables.device)
        signs = self._const("signs", lambda: h["signs"], tables.device)
        return torch.clamp(signs * (spots - strikes), min=0.0) / numeraire

    def _hinge_groups(self):
        """{(netting set, asset, date, sign): strikes} in product order."""
        def build():
            groups = defaultdict(list)
            for i, p in enumerate(self.products):
                sign = 1.0 if p.option_type == OptionType.CALL else -1.0
                groups[(int(self.ns_idx[i]), p.underlying.get_asset_id(), p.exercise_date,
                        sign)].append(p.strike)
            return groups
        return self._table("hinge_groups", build)

    def segmented_cashflows(self, tables, n_ns: int, num_paths: int):
        """Per-netting-set pathwise cashflows [n_ns, N] in O(groups x N).

        A European book's cashflow at one (netting set, asset, date, sign) is
        a sum of hinges of one spot:
            calls:  sum_p max(S - k_p, 0) = S c(S) - prefix[c(S)]
            puts:   sum_p max(k_p - S, 0) = (total - prefix[c(S)]) - S (K - c(S))
        with c(S) = #{sorted strikes <= S} from a searchsorted.  That replaces
        the dense [P, N] payoff matrix with a few [N]-sized piecewise-linear
        evaluations, and keeps a reverse pass at [groups, N]."""
        if len(self.products) * num_paths * _itemsize() <= self.CASHFLOW_CHUNK_BYTES:
            # the dense [P, N] fits the temp budget: one payoff beats a chain
            # of per-group ops
            return super().segmented_cashflows(tables, n_ns, num_paths)
        groups = self._hinge_groups()
        if len(self.products) < self.HINGE_SUM_MIN_RATIO * len(groups):
            return super().segmented_cashflows(tables, n_ns, num_paths)
        total = torch.zeros((n_ns, num_paths), dtype=real_dtype(), device=tables.device)
        for g, ((ns, asset, date, sign), ks) in enumerate(sorted(groups.items())):
            t_i, t_v = np.array([self.time_to_index[date]]), np.array([date])
            spot = tables.rows(AtomicRequestType.SPOT, asset, t_i, t_v)[0].contiguous()
            numeraire = tables.rows(AtomicRequestType.NUMERAIRE, "numeraire", t_i, t_v)[0]
            ks_sorted = lambda: np.sort(np.asarray(ks, dtype=float))
            ks_dev = self._const(f"hinge:{g}:k", ks_sorted, tables.device)
            prefix = self._const(f"hinge:{g}:prefix", lambda: np.concatenate(
                [[0.0], np.cumsum(ks_sorted())]), tables.device)
            c = torch.searchsorted(ks_dev, spot, right=True)
            if sign > 0:
                val = spot * c - prefix[c]
            else:
                val = (prefix[-1] - prefix[c]) - spot * (len(ks) - c)
            seg = self._const(f"hinge:{g}:ns", lambda: [ns], tables.device, torch.long)
            total = total.index_add(0, seg, (val / numeraire)[None])
        return total

    # -- analytic exposure fast path (european_option.py, batched) ---------------

    def fit_exposure(self, tables, ctx):
        if self.use_analytic_exposure:
            return  # the closed form needs no pre-simulation fit
        super().fit_exposure(tables, ctx)

    def exposure_contributions(self, tables: ObservableTables, ctx: ExposureContext):
        """Per-netting-set profiles [T_exp, n_ns, N]; on the analytic path
        the Black-Scholes value of every live option on every path, summed
        per netting set in product chunks (one [chunk, N] price block live
        per date)."""
        if not self.use_analytic_exposure:
            return super().exposure_contributions(tables, ctx)
        model, params = self.analytic_model, tables.params
        if isinstance(model, BlackScholesMulti):
            rate = params[2 * model.num_assets]
            vol_of = lambda a: params[model.num_assets + model.asset_ids.index(a)]
        else:
            rate, vol_of = params[2], lambda a: params[1]
        t_grid = np.array(ctx.exposure_timeline)
        tidx = np.array([self.time_to_index[t] for t in t_grid])
        n_ns, dev = ctx.num_netting_sets, tables.device
        chunk = self._cashflow_chunk(tables.num_paths)
        maturities = self.maturities()
        ndtr = torch.special.ndtr
        total = torch.zeros((len(t_grid), n_ns, tables.num_paths), dtype=real_dtype(), device=dev)
        for a, p_rows in self._by_asset().items():
            spot_rows = tables.rows(AtomicRequestType.SPOT, a, tidx, t_grid)          # [T, N]
            num_rows = tables.rows(AtomicRequestType.NUMERAIRE, "numeraire", tidx, t_grid)
            sigma = vol_of(a)
            chunks = [p_rows[lo:lo + chunk] for lo in range(0, len(p_rows), chunk)]
            rows = []
            for t, t_now in enumerate(t_grid):
                spot = spot_rows[t][None, :]
                acc = None
                for c, rows_c in enumerate(chunks):
                    tau_raw = maturities[rows_c] - t_now
                    if not (tau_raw > 0.0).any():
                        continue
                    key = f"analytic:{a}:{chunk}:{c}"
                    tau = self._const(f"{key}:{t}:tau", lambda: np.where(
                        tau_raw > 0.0, tau_raw, 1.0)[:, None], dev)
                    alive = self._const(f"{key}:{t}:alive", lambda: (tau_raw > 0.0)[:, None], dev,
                                        torch.bool)
                    k = self._const(f"{key}:k", lambda: np.array(
                        [self.products[i].strike for i in rows_c])[:, None], dev)
                    is_call = self._const(f"{key}:call", lambda: np.array(
                        [self.products[i].option_type == OptionType.CALL
                         for i in rows_c])[:, None], dev, torch.bool)
                    seg = self._const(f"{key}:ns", lambda: self.ns_idx[rows_c], dev,
                                      torch.long)
                    sqrt_tau = torch.sqrt(tau)
                    d1 = (torch.log(spot / k) + (rate + 0.5 * sigma * sigma) * tau) / (
                        sigma * sqrt_tau)
                    d2 = d1 - sigma * sqrt_tau
                    disc_k = k * torch.exp(-rate * tau)
                    call = spot * ndtr(d1) - disc_k * ndtr(d2)
                    put = disc_k * ndtr(-d2) - spot * ndtr(-d1)
                    price = torch.where(alive, torch.where(is_call, call, put), 0.0)
                    acc = _segment_sum(price / num_rows[t][None, :], seg, n_ns, acc)
                rows.append(torch.zeros_like(total[0]) if acc is None else acc)
            total = total + torch.stack(rows)
        return total


class BinaryBatch(TerminalBatch):
    HINGE_SUM_MIN_RATIO = 4

    @staticmethod
    def accepts(product) -> bool:
        return isinstance(product, BinaryOption)

    @staticmethod
    def group_key(product):
        return ("binary",)

    def cashflows(self, tables: ObservableTables):
        def build():
            prods = self.products
            return dict(
                tidx=np.array([self.time_to_index[p.maturity] for p in prods]),
                times=np.array([p.maturity for p in prods]),
                assets=[p.get_asset_id() for p in prods],
                strikes=np.array([p.strike for p in prods])[:, None],
                amounts=np.array([p.payment_amount for p in prods])[:, None],
                is_call=np.array([1.0 if p.option_type == OptionType.CALL else 0.0
                                  for p in prods])[:, None])
        h = self._table("terms", build)
        dev = tables.device
        spots = self._spot_matrix(tables, h["assets"], h["tidx"][:, None],
                                  h["times"][:, None])[:, 0, :]
        numeraire = self._numeraires(tables, h["tidx"], h["times"])
        strikes = self._const("strikes", lambda: h["strikes"], dev)
        amounts = self._const("amounts", lambda: h["amounts"], dev)
        is_call = self._const("is_call", lambda: h["is_call"], dev)
        above = compute_degree_of_truth(spots - strikes, True, 1.0)
        payoff = amounts * (is_call * above + (1.0 - is_call) * (1.0 - above))
        return payoff / numeraire

    def segmented_cashflows(self, tables, n_ns: int, num_paths: int):
        """Per-netting-set digital cashflows in O(groups x N).

        The fuzzy digital payoff clip((S - k + eps) / 2 eps, 0, 1) (eps = 1)
        is piecewise linear in S, so a group's payment-weighted sum comes
        from two searchsorteds against the sorted strikes and the payment and
        payment x strike prefix sums: the digital analogue of the European
        hinge sum."""
        if len(self.products) * num_paths * _itemsize() <= self.CASHFLOW_CHUNK_BYTES:
            return super().segmented_cashflows(tables, n_ns, num_paths)

        def build():
            groups = defaultdict(list)
            for i, p in enumerate(self.products):
                groups[(int(self.ns_idx[i]), p.get_asset_id(), p.maturity,
                        p.option_type == OptionType.CALL)].append((p.strike, p.payment_amount))
            return groups
        groups = self._table("ramp_groups", build)
        if len(self.products) < self.HINGE_SUM_MIN_RATIO * len(groups):
            return super().segmented_cashflows(tables, n_ns, num_paths)
        eps, dev = 1.0, tables.device
        total = torch.zeros((n_ns, num_paths), dtype=real_dtype(), device=dev)
        for g, ((ns, asset, date, is_call), pairs) in enumerate(sorted(groups.items())):
            t_i, t_v = np.array([self.time_to_index[date]]), np.array([date])
            spot = tables.rows(AtomicRequestType.SPOT, asset, t_i, t_v)[0]
            numeraire = tables.rows(AtomicRequestType.NUMERAIRE, "numeraire", t_i, t_v)[0]
            srt = sorted(pairs)
            ks = np.array([k for k, _ in srt])
            amts = np.array([x for _, x in srt])
            ks_dev = self._const(f"ramp:{g}:k", lambda: ks, dev)
            pay = self._const(f"ramp:{g}:pay", lambda: np.concatenate([[0.0], np.cumsum(amts)]),
                              dev)
            payk = self._const(f"ramp:{g}:payk", lambda: np.concatenate(
                [[0.0], np.cumsum(amts * ks)]), dev)
            c1 = torch.searchsorted(ks_dev, (spot - eps).contiguous(), right=True)
            c2 = torch.searchsorted(ks_dev, (spot + eps).contiguous(), right=False)
            band = ((spot + eps) * (pay[c2] - pay[c1]) - (payk[c2] - payk[c1])) / (2.0 * eps)
            val_above = pay[c1] + band  # sum_p amt_p clip((S - k_p + eps) / 2 eps, 0, 1)
            val = val_above if is_call else (pay[-1] - val_above)
            seg = self._const(f"ramp:{g}:ns", lambda: [ns], dev, torch.long)
            total = total.index_add(0, seg, (val / numeraire)[None])
        return total


class BasketBatch(TerminalBatch):
    @staticmethod
    def accepts(product) -> bool:
        return isinstance(product, BasketOption) and not product.use_variation_reduction

    @staticmethod
    def group_key(product):
        return ("basket", len(product.asset_ids))

    def cashflows(self, tables: ObservableTables):
        def build():
            prods = self.products
            return dict(
                tidx=np.array([self.time_to_index[p.maturity] for p in prods]),
                times=np.array([p.maturity for p in prods]),
                strikes=np.array([p.strike for p in prods])[:, None],
                signs=np.array([1.0 if p.option_type == OptionType.CALL else -1.0
                                for p in prods])[:, None],
                weights=np.array([p.weights for p in prods])[:, :, None],          # [P, A, 1]
                is_geo=np.array([p.basket_option_type == BasketOptionType.GEOMETRIC
                                 for p in prods])[:, None])
        h = self._table("terms", build)
        dev = tables.device
        n_assets = len(self.products[0].asset_ids)
        tidx, times = h["tidx"][:, None], h["times"][:, None]
        spots = torch.stack([
            self._spot_matrix(tables, [p.asset_ids[k] for p in self.products], tidx, times,
                              name=f"spots:{k}")[:, 0, :]
            for k in range(n_assets)], dim=1)                                          # [P, A, N]
        weights = self._const("weights", lambda: h["weights"], dev)
        # the weighted sums over the small asset axis as mul-adds, as each
        # product's own payoff takes them
        arith = (spots * weights).sum(1)
        geo = torch.exp((torch.log(spots + 1e-10) * weights).sum(1))
        basket = torch.where(self._const("is_geo", lambda: h["is_geo"], dev, torch.bool), geo,
                             arith)
        numeraire = self._numeraires(tables, h["tidx"], h["times"])
        strikes = self._const("strikes", lambda: h["strikes"], dev)
        signs = self._const("signs", lambda: h["signs"], dev)
        return torch.clamp(signs * (basket - strikes), min=0.0) / numeraire


class AsianBatch(TerminalBatch):
    @staticmethod
    def accepts(product) -> bool:
        return isinstance(product, AsianOption)

    @staticmethod
    def group_key(product):
        return ("asian", len(product.modeling_timeline))

    def cashflows(self, tables: ObservableTables):
        def build():
            prods = self.products
            return dict(
                tidx=np.array([[self.time_to_index[t] for t in p.modeling_timeline]
                               for p in prods]),
                times=np.array([list(p.modeling_timeline) for p in prods]),
                assets=[p.get_asset_id() for p in prods],
                strikes=np.array([p.strike for p in prods])[:, None],
                signs=np.array([1.0 if p.option_type == OptionType.CALL else -1.0
                                for p in prods])[:, None],
                is_geo=np.array([p.averaging_type == AsianAveragingType.GEOMETRIC
                                 for p in prods])[:, None])
        h = self._table("terms", build)
        dev = tables.device
        spots = self._spot_matrix(tables, h["assets"], h["tidx"], h["times"])        # [P, O, N]
        arith = torch.mean(spots, dim=1)
        geo = torch.exp(torch.mean(torch.log(spots + 1e-10), dim=1))
        average = torch.where(self._const("is_geo", lambda: h["is_geo"], dev, torch.bool), geo,
                              arith)
        numeraire = self._numeraires(tables, h["tidx"][:, -1], h["times"][:, -1])
        strikes = self._const("strikes", lambda: h["strikes"], dev)
        signs = self._const("signs", lambda: h["signs"], dev)
        return torch.clamp(signs * (average - strikes), min=0.0) / numeraire


class BarrierBatch(TerminalBatch):
    @staticmethod
    def accepts(product) -> bool:
        return isinstance(product, BarrierOption) and not product.use_brownian_bridge

    @staticmethod
    def group_key(product):
        return ("barrier", len(product.modeling_timeline), product.barrier2 is not None)

    def _weight_arrays(self, attr_type, attr_level, dev):
        """([P, 1] is-up, [P, 1] is-out, [P, 1] level) of one barrier."""
        prods = self.products
        up = (BarrierOptionType.UPANDOUT, BarrierOptionType.UPANDIN)
        out = (BarrierOptionType.UPANDOUT, BarrierOptionType.DOWNANDOUT)
        return (self._const(f"{attr_type}:up", lambda: np.array(
                    [getattr(p, attr_type) in up for p in prods])[:, None], dev, torch.bool),
                self._const(f"{attr_type}:out", lambda: np.array(
                    [getattr(p, attr_type) in out for p in prods])[:, None], dev, torch.bool),
                self._const(attr_level, lambda: np.array(
                    [getattr(p, attr_level) for p in prods])[:, None], dev))

    @staticmethod
    def _barrier_weight(max_spot, min_spot, is_up, is_out, level):
        below_max = compute_degree_of_truth(level - max_spot, True)
        above_min = compute_degree_of_truth(min_spot - level, True)
        survive = torch.where(is_up, below_max, above_min)
        return torch.where(is_out, survive, 1.0 - survive)

    def cashflows(self, tables: ObservableTables):
        def build():
            prods = self.products
            return dict(
                tidx=np.array([[self.time_to_index[t] for t in p.modeling_timeline]
                               for p in prods]),
                times=np.array([list(p.modeling_timeline) for p in prods]),
                assets=[p.get_asset_id() for p in prods],
                strikes=np.array([p.strike for p in prods])[:, None],
                signs=np.array([1.0 if p.option_type == OptionType.CALL else -1.0
                                for p in prods])[:, None])
        h = self._table("terms", build)
        dev = tables.device
        spots = self._spot_matrix(tables, h["assets"], h["tidx"], h["times"])        # [P, O, N]
        strikes = self._const("strikes", lambda: h["strikes"], dev)
        signs = self._const("signs", lambda: h["signs"], dev)
        payoff = torch.clamp(signs * (spots[:, -1, :] - strikes), min=0.0)
        max_spot, min_spot = torch.max(spots, dim=1).values, torch.min(spots, dim=1).values
        payoff = payoff * self._barrier_weight(
            max_spot, min_spot, *self._weight_arrays("barrier_option_type1", "barrier1", dev))
        if self.products[0].barrier2 is not None:
            payoff = payoff * self._barrier_weight(
                max_spot, min_spot, *self._weight_arrays("barrier_option_type2", "barrier2", dev))
        numeraire = self._numeraires(tables, h["tidx"][:, -1], h["times"][:, -1])
        return payoff / numeraire


class ExerciseEquityBatch(TerminalBatch):
    """Product-batched LSM for Bermudan, American and FlexiCall options on an
    equity.

    The backward fit and the forward valuation each run as one loop over
    the merged events with all P products in the carry: batched Gram solves
    replace the per-product fits, and the exercise decision is vectorised
    over [P, N, S].
    """

    def __init__(self, products, ns_idx, time_to_index, regression_function):
        super().__init__(products, ns_idx, time_to_index)
        self.regression_function = regression_function
        self.is_flexi = isinstance(products[0], FlexiCall)
        self.num_states = max(p.get_num_states() for p in products)
        self._coeffs = None  # [E, P, S, deg], set by fit()

    @staticmethod
    def accepts(product) -> bool:
        if isinstance(product, FlexiCall):
            return all(isinstance(o.underlying, Equity) for o in product.underlyings)
        if isinstance(product, BermudanOption):
            return isinstance(product.underlying_requests[0].underlying_asset, Equity)
        return False

    @staticmethod
    def group_key(product):
        kind = "flexi" if isinstance(product, FlexiCall) else "bermudan"
        return ("exercise", kind, len(product.product_timeline))

    def release(self) -> None:
        super().release()
        self._coeffs = None

    # -- shared table building ------------------------------------------------

    def _host_events(self, exposure_times):
        """Host event tables: each product's exercise dates and every exposure
        date in time order, product dates first on ties (step, then
        observe); all products share the event count E + T_exp."""
        prods = self.products
        strikes_per_prod = [p.scan_event_strikes() for p in prods]
        e_tot = len(prods[0].product_timeline) + len(exposure_times)
        P = len(prods)
        times_mat = np.zeros((P, e_tot))
        tidx_mat = np.zeros((P, e_tot), dtype=np.int64)
        strike_mat = np.zeros((P, e_tot))
        is_prod = np.zeros((P, e_tot), dtype=bool)
        exp_row_idx = np.zeros((len(exposure_times), P), dtype=np.int64)
        for p_idx, p in enumerate(prods):
            events = [(t, 1, strikes_per_prod[p_idx][i], -1)
                      for i, t in enumerate(p.product_timeline)]
            events += [(t, 0, 0.0, s) for s, t in enumerate(exposure_times)]
            events.sort(key=lambda e: (e[0], -e[1]))
            for row, (t, flag, strike, slot) in enumerate(events):
                times_mat[p_idx, row] = t
                tidx_mat[p_idx, row] = self.time_to_index[t]
                strike_mat[p_idx, row] = strike
                is_prod[p_idx, row] = bool(flag)
                if slot >= 0:
                    exp_row_idx[slot, p_idx] = row
        sign_of = (lambda p: p.underlyings[0].option_type) if self.is_flexi else (
            lambda p: p.option_type)
        signs = np.array([1.0 if sign_of(p) == OptionType.CALL else -1.0 for p in prods])
        itm = np.array([getattr(p, "itm_only_regression", False) for p in prods])
        return dict(times=times_mat, tidx=tidx_mat, strikes=strike_mat.T, is_prod=is_prod.T,
                    exp_rows=exp_row_idx, signs=signs, itm=itm,
                    init=np.array([p.get_initial_state() for p in prods]))

    def observation_rows(self, exposure_times):
        """(host event tables, the (kind, asset, time indices, times) blocks
        of resolved rows that ``_event_tables`` gathers, and per product and
        event its spot row and its numeraire row in those blocks stacked,
        [P, E] each), for ops/exercise_scan.py's flat tables."""
        name = f"events:{len(exposure_times)}"
        h = self._table(name, lambda: self._host_events(exposure_times))
        plan, spot_rows = self._spot_plan([p.get_asset_id() for p in self.products], h["tidx"],
                                          h["times"], name + ":spots")
        uniq, inverse, time_u = self._table(name + ":numeraires", lambda: _unique_rows(
            h["tidx"].ravel(), h["times"].ravel()))
        blocks = [(AtomicRequestType.SPOT, a, u, t) for a, u, t in plan]
        blocks.append((AtomicRequestType.NUMERAIRE, "numeraire", uniq, time_u))
        offset = sum(len(u) for _, u, _ in plan)
        return h, blocks, spot_rows, offset + inverse.reshape(spot_rows.shape)

    def _event_tables(self, tables: ObservableTables, ctx: Optional[ExposureContext]):
        """(spots [E, P, N], numeraires [E, P, N], strikes [E, P], is_prod
        [E, P], signs [P], host tables) of the merged events."""
        exposure_times = tuple(ctx.exposure_timeline) if ctx is not None else ()
        name = f"events:{len(exposure_times)}"
        h = self._table(name, lambda: self._host_events(exposure_times))
        dev = tables.device
        spots = self._spot_matrix(tables, [p.get_asset_id() for p in self.products], h["tidx"],
                                  h["times"], name=name + ":spots")
        numeraires = self._numeraires(tables, h["tidx"].ravel(), h["times"].ravel(),
                                      name=name + ":numeraires").reshape(spots.shape)
        return (spots.transpose(0, 1), numeraires.transpose(0, 1),
                self._const(name + ":strikes", lambda: h["strikes"], dev),
                self._const(name + ":is_prod", lambda: h["is_prod"], dev, torch.bool),
                self._const("signs", lambda: h["signs"], dev), h)

    @staticmethod
    def _shift_down(values):
        """values[..., s] -> values[..., max(s - 1, 0)] along the state axis."""
        return torch.cat([values[..., :1], values[..., :-1]], dim=-1)

    def _immediate(self, signs, spots_e, strike_e):
        return torch.clamp(signs[:, None] * (spots_e - strike_e[:, None]), min=0.0)

    def _hypothetical_step(self, carry, spots_e, num_e, strike_e, signs, coeffs, itm_gate):
        """One backward event on the all-states carry C [P, N, S]."""
        grid = matmul_t(self.regression_function.get_regression_matrix(spots_e), coeffs)  # [P, N, S]
        immediate = self._immediate(signs, spots_e, strike_e)[:, :, None]        # [P, N, 1]
        s_positive = torch.arange(self.num_states, device=grid.device) > 0
        if self.is_flexi:
            exercised = (immediate + self._shift_down(grid) > grid) & s_positive
        else:
            exercised = (immediate > grid) & s_positive
        # in-the-money-gated products never exercise out of the money
        exercised = exercised & (~itm_gate[:, None, None] | (immediate > 0.0))
        cfs = immediate * exercised.to(immediate.dtype) / num_e[:, :, None]
        return cfs + torch.where(exercised, self._shift_down(carry), carry)

    def _exercise_span(self, spots, phase: str):
        """The ``exercise`` span of one loop over the events ``spots`` [E, P, N]."""
        return tracing.span("exercise", kind=type(self.products[0]).__name__,
                            products=len(self.products), steps=int(spots.shape[0]), phase=phase,
                            route="torch")

    def fit(self, tables: ObservableTables, ctx: Optional[ExposureContext] = None):
        """The LSM fit, last event first: coefficients [E, P, S, deg]."""
        spots, numeraires, strikes, is_prod, signs, h = self._event_tables(tables, ctx)
        dev = tables.device
        itm_gate = self._const("itm", lambda: h["itm"], dev, torch.bool)
        use_itm = bool(h["itm"].any())
        carry = torch.zeros((len(self.products), tables.num_paths, self.num_states),
                            dtype=real_dtype(), device=dev)
        coeffs_all = [None] * spots.shape[0]
        with self._exercise_span(spots, "fit"):
            for e in reversed(range(spots.shape[0])):
                spots_e, num_e, strike_e, is_prod_e = spots[e], numeraires[e], strikes[e], is_prod[e]
                weights = None
                if use_itm:
                    itm = (signs[:, None] * (spots_e - strike_e[:, None]) > 0.0).to(spots_e.dtype)
                    weights = torch.where((itm_gate & is_prod_e)[:, None], itm, 1.0)
                coeffs = fit_least_squares(self.regression_function.get_regression_matrix(spots_e),
                                           num_e[:, :, None] * carry, weights=weights,
                                           sharding=tables.sharding)
                stepped = self._hypothetical_step(carry, spots_e, num_e, strike_e, signs, coeffs,
                                                  itm_gate)
                carry = torch.where(is_prod_e[:, None, None], stepped, carry)
                coeffs_all[e] = coeffs
            self._coeffs = torch.stack(coeffs_all)

    def evaluate(self, tables: ObservableTables, ctx: Optional[ExposureContext] = None):
        """Forward sweep: (cfs [P, N], exposures [T_exp, P, N] or None)."""
        spots, numeraires, strikes, is_prod, signs, h = self._event_tables(tables, ctx)
        dev = tables.device
        itm_gate = self._const("itm", lambda: h["itm"], dev, torch.bool)
        want_exposures = ctx is not None and len(ctx.exposure_timeline) > 0
        state = self._const("init", lambda: h["init"], dev, torch.long)[:, None].expand(
            -1, tables.num_paths)
        cfs = torch.zeros((len(self.products), tables.num_paths), dtype=real_dtype(), device=dev)
        take = lambda grid, s: torch.gather(grid, -1, s[..., None])[..., 0]
        exposures = []
        with self._exercise_span(spots, "value"):
            for e in range(spots.shape[0]):
                spots_e, num_e, strike_e = spots[e], numeraires[e], strikes[e]
                grid = matmul_t(self.regression_function.get_regression_matrix(spots_e),
                                self._coeffs[e])
                cont_hold = take(grid, state)
                immediate = self._immediate(signs, spots_e, strike_e)
                if self.is_flexi:
                    cont_ex = take(grid, torch.clamp(state - 1, min=0))
                    exercised = (immediate + cont_ex > cont_hold) & (state > 0)
                else:
                    exercised = (immediate > cont_hold) & (state > 0)
                exercised = (exercised & is_prod[e][:, None]
                             & (~itm_gate[:, None] | (immediate > 0.0)))
                cfs = cfs + immediate * exercised.to(immediate.dtype) / num_e
                state = state - exercised.long()
                if want_exposures:
                    # the realized state's continuation, read after the step
                    exposures.append(take(grid, state) / num_e)
        if not want_exposures:
            return cfs, None
        # each product's own exposure rows -> [T_exp, P, N]
        rows = self._const("exp_rows", lambda: h["exp_rows"], dev, torch.long)
        cols = self._const("exp_cols", lambda: np.arange(len(self.products))[None, :], dev,
                           torch.long)
        return cfs, torch.stack(exposures)[rows, cols]

    def cashflows(self, tables: ObservableTables):
        return self.evaluate(tables, None)[0]


class CouponBatch(TerminalBatch):
    """All Bond and InterestRateSwap products in one event-table executor.

    Every coupon collapses into static host event tables:

      * fixed and notional events: (product row, pay date, signed amount),
        the amount a host constant (the notional at the last date where the
        leg pays it);
      * float events: (product row, pay date, signed notional x accrual,
        LIBOR fixing (t1, t2), asset), on the LIBOR rows the per-product path
        resolves, the sign from the IRSType.

    Cashflows are one segment-sum over event chunks.  The exposure fit
    replaces the terminal-maturity mask with a descending-date sweep that
    accumulates each product's strictly-future cashflows (pay > t), then
    solves the shared power-sum Gram per asset.
    """

    @staticmethod
    def accepts(product) -> bool:
        return type(product) in (Bond, InterestRateSwap)

    @staticmethod
    def group_key(product):
        return ("coupon",)

    def __init__(self, products, ns_idx, time_to_index):
        super().__init__(products, ns_idx, time_to_index)
        self._build_events()

    @staticmethod
    def _legs(p):
        if isinstance(p, InterestRateSwap):
            fixed_sign = -1.0 if p.irs_type == IRSType.PAYER else 1.0
            return [(p.fixed_leg, fixed_sign), (p.floating_leg, -fixed_sign)]
        return [(p, 1.0)]

    def _build_events(self):
        self._fixed_events = []
        self._float_events = []
        for row, p in enumerate(self.products):
            for leg, sign in self._legs(p):
                asset = leg.get_asset_id()
                prev = leg.startdate
                last = len(leg.payment_dates) - 1
                for idx, date in enumerate(leg.payment_dates):
                    dt = date - prev
                    prev = date
                    if leg.fixed_rate is not None:
                        amount = sign * leg.notional * leg.fixed_rate * dt
                        if leg.pays_notional and idx == last:
                            amount += sign * leg.notional
                        self._fixed_events.append((row, date, amount))
                    else:
                        lreq = leg.libor_requests[(idx, asset)]
                        self._float_events.append((row, date, sign * leg.notional * dt,
                                                   (lreq.time1, lreq.time2), asset))
                        if leg.pays_notional and idx == last:
                            self._fixed_events.append((row, date, sign * leg.notional))

    def _event_rows(self, tables, fixed_evs, float_evs, name: str):
        """(product rows [E] host ints, normalized cashflow rows [E, N]) of
        explicit event lists, in event chunks; ``name`` keys their amounts'
        device constants."""
        n = tables.num_paths
        chunk = self._cashflow_chunk(n)
        dev = tables.device
        amounts = lambda key, evs: self._const(f"{name}:{chunk}:{key}", lambda: np.array(
            [e[2] for e in evs], dtype=np.float64), dev)
        prod_rows, pieces = [], []
        for lo in range(0, len(fixed_evs), chunk):
            evs = fixed_evs[lo:lo + chunk]
            times = np.array([e[1] for e in evs])
            num = tables.rows(AtomicRequestType.NUMERAIRE, "numeraire",
                              np.array([self.time_to_index[t] for t in times]), times)
            pieces.append(amounts(f"fixed:{lo}", evs)[:, None] / num)
            prod_rows.extend(e[0] for e in evs)
        by_asset = defaultdict(list)
        for e in float_evs:
            by_asset[e[4]].append(e)
        for a, evs_a in sorted(by_asset.items()):
            for lo in range(0, len(evs_a), chunk):
                evs = evs_a[lo:lo + chunk]
                times = np.array([e[1] for e in evs])
                tidx = np.array([self.time_to_index[t] for t in times])
                num = tables.rows(AtomicRequestType.NUMERAIRE, "numeraire", tidx, times)
                libor = tables.request_rows(AtomicRequestType.LIBOR_RATE, a, tidx,
                                            np.array([e[3][0] for e in evs]),
                                            np.array([e[3][1] for e in evs]))
                pieces.append(amounts(f"float:{a}:{lo}", evs)[:, None] * libor / num)
                prod_rows.extend(e[0] for e in evs)
        if not pieces:
            return np.zeros(0, dtype=np.int64), torch.zeros((0, n), dtype=real_dtype(), device=dev)
        return np.array(prod_rows, dtype=np.int64), torch.cat(pieces, dim=0)

    def cashflows(self, tables) -> torch.Tensor:
        """[P, N] total normalized cashflows per product."""
        prod_rows, rows = self._event_rows(tables, self._fixed_events, self._float_events, "all")
        seg = self._const("event_rows", lambda: prod_rows, tables.device, torch.long)
        return _segment_sum(rows, seg, len(self.products))

    def _future_event_buckets(self, t_grid, rows_c):
        """{grid index k: (fixed events, float events)} of the products
        ``rows_c``, each event at the last grid date strictly before its pay
        date (it is a future cashflow at every t <= t_grid[k])."""
        rows_c = set(int(r) for r in rows_c)
        buckets = defaultdict(lambda: ([], []))
        for which, events in ((0, self._fixed_events), (1, self._float_events)):
            for e in events:
                if e[0] in rows_c:
                    k_e = int(np.searchsorted(t_grid, e[1], side="left")) - 1
                    if k_e >= 0:
                        buckets[k_e][which].append(e)
        return dict(buckets)

    def fit_exposure(self, tables, ctx) -> None:
        """Future-cashflow exposure regression on the internal exposure grid:
        descending over the grid, events enter the running [Pc, N]
        future-cashflow accumulator at the last grid date before their pay
        date, and a date's right-hand side is the tree sum of the weighted
        basis [deg, N] times the accumulator, a chunk of dates in one tree
        sum (the [Tc, deg, Pc, N] temp bounded by ``_date_chunk``)."""
        deg = ctx.regression_function.get_degree()
        t_grid = np.array(ctx.exposure_timeline)
        n = tables.num_paths
        chunk = self._cashflow_chunk(n * deg)  # the [deg, Pc, N] products of a date
        self._exp_coeffs = {}
        for a, p_rows in self._by_asset().items():
            expl, numeraire = self._exposure_grid_obs(tables, ctx, a)
            gram, col_scale, s1 = self._exposure_gram(expl, deg, tables.sharding)
            local = {int(g): i for i, g in enumerate(p_rows)}
            rhs_chunks = []
            for lo in range(0, len(p_rows), chunk):
                rows_c = p_rows[lo:lo + chunk]
                buckets = self._table(f"future:{a}:{lo}:{len(t_grid)}",
                                      lambda: self._future_event_buckets(t_grid, rows_c))
                cf_future = torch.zeros((len(rows_c), n), dtype=real_dtype(), device=tables.device)
                t_chunk = self._date_chunk(deg * len(rows_c) * n)
                blocks, held = [], []  # held: the accumulator at t_hi - 1, t_hi - 2, ...
                for t in range(len(t_grid) - 1, -1, -1):
                    if t in buckets:
                        ev_rows, ev_vals = self._event_rows(tables, *buckets[t],
                                                            name=f"future:{a}:{lo}:{t}")
                        seg = self._const(f"future:{a}:{lo}:{t}:seg", lambda: np.array(
                            [local[int(r)] - lo for r in ev_rows]), tables.device, torch.long)
                        cf_future = _segment_sum(ev_vals, seg, len(rows_c), cf_future)
                    held.append(cf_future)
                    if len(held) == t_chunk or t == 0:
                        # dates t .. t + Tc - 1 in one tree sum of [Tc, deg, Pc, N]
                        w = self._weighted_basis(numeraire, expl, s1, t, t + len(held), deg)
                        cf = torch.stack(held[::-1])                             # [Tc, Pc, N]
                        blocks.append(fixed_tree_sum(w[:, :, None, :] * cf[:, None], -1))
                        held = []
                rhs_chunks.append(torch.cat(blocks[::-1]))                       # [T, deg, Pc]
            rhs = sum_over_ranks(torch.cat(rhs_chunks, dim=-1), tables.sharding)
            sol = _solve(gram, rhs) / col_scale[:, :, None]
            self._exp_coeffs[a] = sol.transpose(1, 2)                           # [T, Pa, deg]


BATCH_CLASSES = [
    EuropeanEquityBatch,
    BinaryBatch,
    BasketBatch,
    AsianBatch,
    BarrierBatch,
    ExerciseEquityBatch,
    CouponBatch,
]


def plan_batches(products, product_to_ns_idx, time_to_index, regression_function):
    """Partition products into batched groups and per-product leftovers.

    Returns (batches, ids of the batched product objects)."""
    groups: Dict[tuple, List[int]] = defaultdict(list)
    group_cls: Dict[tuple, type] = {}
    for idx, product in enumerate(products):
        for cls in BATCH_CLASSES:
            if cls.accepts(product):
                key = (cls.__name__,) + tuple(cls.group_key(product))
                groups[key].append(idx)
                group_cls[key] = cls
                break

    batches = []
    batched_ids = set()
    for key, indices in groups.items():
        cls = group_cls[key]
        prods = [products[i] for i in indices]
        ns_idx = np.array([product_to_ns_idx[i] for i in indices])
        if cls is ExerciseEquityBatch:
            batches.append(cls(prods, ns_idx, time_to_index, regression_function))
        else:
            batches.append(cls(prods, ns_idx, time_to_index))
        batched_ids.update(id(products[i]) for i in indices)
    return batches, batched_ids
