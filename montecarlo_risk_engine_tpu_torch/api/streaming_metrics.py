"""Streaming metric pipeline: exposure, netting and metric reductions inside
the path loop.

Counterpart of ``montecarlo_risk_engine_tpu/api/streaming_metrics.py``.
The plane pipeline keeps every request row ([rows, N]: 342 rows at the
north star) and a [T_exp, N] exposure stack per netting set; at 16.8M paths
those alone outgrow the card.  Here the engine's ``fold`` hook
(engine.simulate_paths) consumes each timeline point's request rows right
after its substeps:

  * per-product regression exposures, Horner on the pre-simulation
    coefficients against the point's spot and numeraire rows, summed into a
    netted [n_ns, N] row that lives for that point only (products in chunks
    of ``EXPOSURE_CHUNK_BYTES``);
  * MPoR collateral rows go to a small ring of stashes (as many slots as
    delayed rows are in flight at once, :func:`_greedy_slots`);
  * per metric date: EPE, ENE, CE and EEPE means through ``fixed_tree_sum``,
    PFE order statistics by bisection (ops/quantile, count reductions only),
    and the pathwise CVA accumulator ``acc += E+(t_k) S(0, t_k) (1 - S(t_k,
    t_k+1))`` fed by the survival rows resolved at the same point.

Under a path sharding (the controller's ``path_sharding``) the fold runs on
this rank's paths and keeps per-rank partials: a date's mean is summed over
the ranks at its point (its squared deviations need it there), its summed
squared deviations and the CVA accumulators once per run, at the end; PFE's
bisection counts across the ranks at each date.

What stays resident is O(N): the state, the stash, one [n_ns, N] CVA
accumulator per CVA metric, and per-date scalars.  The point index is a host
integer, so the exposure-date test of the JAX fold (``lax.cond``) is a
Python branch, and the per-date tables are host lists of tensors: no
in-place write into a tensor that a ``torch.func`` transform captured.

Eligibility (:func:`metric_stream_ineligibility`): exposure books (no PV
metric) whose products all take single-state regression exposures, off the
kernel route.  Every other book keeps the plane pipeline.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch import rng, tracing
from montecarlo_risk_engine_tpu_torch.api.batching import ExerciseEquityBatch
from montecarlo_risk_engine_tpu_torch.config import real_dtype
from montecarlo_risk_engine_tpu_torch.metrics.metrics import (
    MetricType,
    fixed_tree_sum,
    mc_mean_and_error,
    sample_error,
)
from montecarlo_risk_engine_tpu_torch.ops.quantile import order_statistics_bisect
from montecarlo_risk_engine_tpu_torch.parallel.collectives import sum_over_ranks
from montecarlo_risk_engine_tpu_torch.parallel.mesh import local_paths
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequestType

_STREAM_METRICS = {
    MetricType.CE, MetricType.EPE, MetricType.ENE,
    MetricType.EEPE, MetricType.PFE, MetricType.CVA,
}

# Budget for the [P_chunk, N] temporaries of the exposure evaluation.
EXPOSURE_CHUNK_BYTES = 256 * 2**20


def metric_stream_ineligibility(controller) -> Optional[str]:
    """None if the book can run the streaming metric pipeline, else the
    reason (streaming_metrics.py:63-102)."""
    rm = controller.risk_metrics
    if controller._emission_schedule is None:
        return "streaming engine off (no emission schedule)"
    if controller._kernel_active:
        return "fused kernel path active"
    if not rm.requires_exposure_profiles():
        return "no exposure profiles requested"
    if rm.requires_discounted_cashflows():
        return "PV metric requires pathwise cashflow accumulation"
    unsupported = {m.metric_type for m in rm.metrics} - _STREAM_METRICS
    if unsupported:
        return f"unsupported metric types {sorted(t.name for t in unsupported)}"
    if controller.num_paths_presim <= 0:
        return "regression exposures need presim paths"
    for p in controller.products:
        if len(p.regression_timeline) > 0:
            return f"{type(p).__name__} has early-exercise regression dates"
        if p.get_num_states() != 1:
            return f"{type(p).__name__} carries a non-trivial exercise state"
        if not controller._product_requires_regression(p):
            return f"{type(p).__name__} uses the analytic exposure path"
    buckets, _ = controller._exercise_scan_groups()
    if buckets:
        return "book contains exercise-scan products"
    for batch in controller._batches:
        if isinstance(batch, ExerciseEquityBatch):
            return f"{type(batch).__name__} has no exposure-fit path"
        if getattr(batch, "use_analytic_exposure", False):
            return f"{type(batch).__name__} uses analytic exposures"
    if controller._emission_schedule.ambiguous_kinds:
        return "ambiguous request kinds in the emission schedule"
    return None


def _greedy_slots(intervals: List[Tuple[int, int, int]]):
    """Ring slots for [start, end] live intervals keyed by id: (number of
    slots, {key: slot}) by greedy interval colouring, so the slot count is
    the largest number of delayed collateral rows in flight at once."""
    slot_of: Dict[int, int] = {}
    free: List[int] = []
    n_slots = 0
    active: List[Tuple[int, int]] = []  # (end, slot)
    for start, end, key in sorted(intervals):
        still_active = []
        for a_end, a_slot in active:
            if a_end < start:
                free.append(a_slot)
            else:
                still_active.append((a_end, a_slot))
        active = still_active
        if free:
            slot = free.pop()
        else:
            slot = n_slots
            n_slots += 1
        slot_of[key] = slot
        active.append((end, slot))
    return n_slots, slot_of


class MetricStreamExecutor:
    """Host tables and the fold of the streaming metric pipeline, built once
    per controller after its request plan and emission schedule; :meth:`run`
    takes the pre-simulation fits."""

    def __init__(self, controller):
        self.c = controller
        sched = controller._emission_schedule
        self.schedule = sched
        self.n_points = len(controller.simulation_timeline)
        self.exposure_timeline = controller.exposure_timeline          # internal
        self.t_exp = len(self.exposure_timeline)
        self.t_m = len(controller.metric_exposure_timeline)
        self.n_ns = len(controller.netting_sets)
        self.sharding = controller.path_sharding
        self.num_paths = local_paths(controller.num_paths_mainsim, self.sharding)[0]  # this rank's
        self.n_global = controller.num_paths_mainsim

        time_to_point = {t: i for i, t in enumerate(controller.simulation_timeline)}
        exp_idx = np.full(self.n_points, -1, dtype=np.int64)   # point -> exposure index
        for j, t in enumerate(self.exposure_timeline):
            exp_idx[time_to_point[t]] = j
        self.exp_idx_tab = exp_idx
        metric_of_exp = np.full(self.t_exp, -1, dtype=np.int64)  # exposure -> metric date
        for i, j in enumerate(controller.metric_exposure_indices):
            metric_of_exp[int(j)] = i
        self.metric_of_exp = metric_of_exp

        def series(asset_id, kind):
            """(group index, per-point row of the group's K, -1 where absent)."""
            g_idx = None
            slots = np.full(self.n_points, -1, dtype=np.int64)
            for p in range(self.n_points):
                h = sched.kind_lookup.get((p, asset_id, kind))
                if h is None:
                    continue
                gi, flat = sched.handle_loc[h]
                if g_idx is None:
                    g_idx = gi
                if gi != g_idx:
                    raise ValueError(f"({asset_id}, {kind}) spans several emission groups")
                slots[p] = flat - p * sched.groups[gi].K
            if g_idx is None:
                raise KeyError(f"no emission rows for ({asset_id}, {kind})")
            return g_idx, slots

        self.numeraire_series = series("numeraire", AtomicRequestType.NUMERAIRE)

        # Products sorted by netting set, so netting is a fixed-order sum.
        _, plain = controller._exercise_scan_groups()
        prod_sources: List[Tuple[str, object]] = [("plain", p) for p in plain]
        ns_of = [controller.product_to_netting_set_idx[p.product_id] for p in plain]
        asset_of = [p.asset_ids[0] for p in plain]
        for batch in controller._batches:
            rows_of = {int(r): (a, k) for a, rows in batch._by_asset().items()
                       for k, r in enumerate(rows)}
            for col in range(len(batch.products)):
                prod_sources.append(("batch", (batch, rows_of[col])))
                ns_of.append(int(batch.ns_idx[col]))
            asset_of.extend(batch.explanatory_assets())
        self.n_products = len(prod_sources)
        if self.n_products != len(controller.products):
            raise ValueError("the metric stream lost track of a product")
        perm = np.argsort(np.asarray(ns_of, dtype=np.int64), kind="stable")
        self._prod_sources = [prod_sources[i] for i in perm]
        self.ns_sorted = np.asarray(ns_of, dtype=np.int64)[perm]
        self.assets = sorted(set(asset_of))
        self.spot_series = [series(a, AtomicRequestType.SPOT) for a in self.assets]
        a_index = {a: i for i, a in enumerate(self.assets)}
        self.asset_idx_sorted = np.asarray([a_index[asset_of[i]] for i in perm], dtype=np.int64)

        itemsize = torch.finfo(real_dtype()).bits // 8
        chunk = max(1, EXPOSURE_CHUNK_BYTES // max(1, self.num_paths * itemsize))
        self.chunks = [(lo, min(lo + chunk, self.n_products))
                       for lo in range(0, self.n_products, chunk)]

        self.thresholds = np.asarray([ns.threshold for ns in controller.netting_sets],
                                     dtype=np.float64)
        self.is_coll = np.asarray([ns.is_collateralized() for ns in controller.netting_sets],
                                  dtype=bool)

        # MPoR collateral stash: a delayed row lives from its date to its
        # last consumer's.
        delayed = controller.netting_set_delayed_exposure_indices  # [n_ns][T_m]
        sources: Dict[int, int] = {}
        for ns_i in range(self.n_ns):
            for i in range(self.t_m):
                d = int(delayed[ns_i][i])
                if d >= 0:
                    consumer = int(controller.metric_exposure_indices[i])
                    sources[d] = max(sources.get(d, d), consumer)
        self.n_slots, slot_of = _greedy_slots([(d, end, d) for d, end in sources.items()])
        self.stash_src_tab = np.full(self.t_exp, -1, dtype=np.int64)
        for d, slot in slot_of.items():
            self.stash_src_tab[d] = slot
        self.read_slot_tab = np.full((self.t_m, self.n_ns), -1, dtype=np.int64)
        for ns_i in range(self.n_ns):
            for i in range(self.t_m):
                d = int(delayed[ns_i][i])
                if d >= 0:
                    self.read_slot_tab[i, ns_i] = slot_of[d]

        metrics = controller.risk_metrics.metrics
        self.need_pos = any(m.metric_type in {MetricType.CE, MetricType.EPE, MetricType.EEPE}
                            for m in metrics)
        self.need_neg = any(m.metric_type == MetricType.ENE for m in metrics)
        self.pfe_metrics = []  # (metric, ks sorted, position of k, se ks, q index)
        for m in metrics:
            if m.metric_type != MetricType.PFE:
                continue
            n = self.n_global
            q_index = int(math.ceil(m.quantile * n)) - 1
            if m.pfe_se == "order-statistic":
                se_ks = m._bracket_indices(n)
            else:
                se_ks = (max(q_index - 1, 0), min(q_index + 1, n - 1))
            ks = sorted({se_ks[0], q_index, se_ks[1]})
            self.pfe_metrics.append((m, ks, {k: i for i, k in enumerate(ks)}, se_ks, q_index))
        self.cva_metrics = []  # (metric, netting-set match, survival series, conditional)
        for m in metrics:
            if m.metric_type != MetricType.CVA:
                continue
            match = np.asarray([ns.counterparty_id is None or ns.counterparty_id == m.counterparty_id
                                for ns in controller.netting_sets])
            self.cva_metrics.append((
                m, match, series(m.counterparty_id, AtomicRequestType.SURVIVAL_PROBABILITY),
                series(m.counterparty_id, AtomicRequestType.CONDITIONAL_SURVIVAL_PROBABILITY)))
        self._device_tabs: Dict[Tuple, torch.Tensor] = {}

    # -- the fold -------------------------------------------------------------

    def _tab(self, name: str, values, dtype, device) -> torch.Tensor:
        """A host table as a device tensor, uploaded once per device."""
        key = (name, dtype, device)
        if key not in self._device_tabs:
            self._device_tabs[key] = torch.as_tensor(values, dtype=dtype, device=device)
        return self._device_tabs[key]

    def _init_aux(self):
        return {"stash": [None] * self.n_slots,
                "cva": [None] * len(self.cva_metrics),
                "pos": [None] * self.t_m, "neg": [None] * self.t_m,
                "pfe": [[None] * self.t_m for _ in self.pfe_metrics]}

    @staticmethod
    def _row(ys, series_pair, point_idx: int):
        g_idx, slots = series_pair
        return ys[g_idx][max(int(slots[point_idx]), 0)]

    def _apply_threshold(self, rows):
        """NettingSet.apply_threshold over [n_ns, N] rows."""
        thr = self._tab("thresholds", self.thresholds, rows.dtype, rows.device)[:, None]
        return torch.where(rows > thr, rows - thr,
                           torch.where(rows < -thr, rows + thr, torch.zeros_like(rows)))

    def _netted_row(self, ys, point_idx: int, exp_j: int, coeffs_all):
        """Netted exposure [n_ns, N] at internal exposure index ``exp_j``: a
        fixed-order sum over the netting-set-sorted product chunks, peak temp
        one [P_chunk, N] block."""
        numeraire = self._row(ys, self.numeraire_series, point_idx)
        spot_rows = torch.stack([torch.broadcast_to(self._row(ys, s, point_idx), (self.num_paths,))
                                 for s in self.spot_series])
        per_ns = [None] * self.n_ns
        coeffs_j = coeffs_all[exp_j]                                    # [P, deg]
        for lo, hi in self.chunks:
            coeffs_c = coeffs_j[lo:hi]
            index = self._tab(f"assets:{lo}", self.asset_idx_sorted[lo:hi], torch.long,
                              spot_rows.device)
            spots_c = spot_rows.index_select(0, index)                    # [Pc, N]
            deg = coeffs_c.shape[-1]
            cont = torch.broadcast_to(coeffs_c[:, deg - 1:deg], spots_c.shape)
            for k in range(deg - 2, -1, -1):
                cont = cont * spots_c + coeffs_c[:, k:k + 1]
            expo = cont / numeraire
            seg = self.ns_sorted[lo:hi]
            starts = np.flatnonzero(np.diff(seg, prepend=seg[0] - 1))
            ends = np.append(starts[1:], len(seg))
            for s, e in zip(starts, ends):
                ns_i = int(seg[s])
                part = fixed_tree_sum(expo[int(s):int(e)])
                per_ns[ns_i] = part if per_ns[ns_i] is None else per_ns[ns_i] + part
        zero = torch.zeros((self.num_paths,), dtype=spot_rows.dtype, device=spot_rows.device)
        return torch.stack([zero if r is None else r for r in per_ns])

    def _on_metric(self, aux, netted, m_i: int, ys, point_idx: int):
        # Unsecured exposure (NettingSet.compute_unsecured_exposure_profiles):
        # collateralised: netted minus the thresholded delayed row;
        # uncollateralised: the thresholded netted row.
        if self.n_slots:
            slots = self.read_slot_tab[m_i]
            stashed = torch.stack([torch.zeros_like(netted[i]) if slots[i] < 0
                                   else aux["stash"][slots[i]][i] for i in range(self.n_ns)])
            collat = torch.where(
                self._tab(f"read:{m_i}", slots >= 0, torch.bool, netted.device)[:, None],
                self._apply_threshold(stashed), torch.zeros_like(stashed))
        else:
            collat = torch.zeros_like(netted)
        is_coll = self._tab("is_coll", self.is_coll, torch.bool, netted.device)[:, None]
        unsec = torch.where(is_coll, netted - collat, self._apply_threshold(netted))

        # (mean [n_ns], this rank's summed squared deviations [n_ns]): the
        # errors follow once per run (_date_errors).  Kept apart: in one
        # tensor, reverse mode would pull the zero cotangent of a
        # zero-variance date's error through sqrt'(0) = inf into the mean's
        # inputs.
        def date_stats(rows):
            mean = fixed_tree_sum(rows.mT, sharding=self.sharding) / self.n_global
            return mean, fixed_tree_sum((rows.mT - mean) ** 2)

        if self.need_pos:
            aux["pos"][m_i] = date_stats(torch.clamp(unsec, min=0.0))
        if self.need_neg:
            aux["neg"][m_i] = date_stats(-torch.clamp(-unsec, min=0.0))
        for idx, (_, ks, _, _, _) in enumerate(self.pfe_metrics):
            aux["pfe"][idx][m_i] = order_statistics_bisect(
                unsec, ks, sharding=self.sharding).mT  # [n_ns, K]
        for c_idx, (_, match, surv_s, cond_s) in enumerate(self.cva_metrics):
            if surv_s[1][point_idx] < 0:
                continue
            surv = self._row(ys, surv_s, point_idx)
            cond = self._row(ys, cond_s, point_idx)
            contrib = torch.clamp(unsec, min=0.0) * (surv * (1.0 - cond))
            mask = self._tab(f"match:{c_idx}", match, torch.bool, netted.device)[:, None]
            add = torch.where(mask, contrib, torch.zeros_like(contrib))
            acc = aux["cva"][c_idx]
            aux["cva"][c_idx] = add if acc is None else acc + add
        return aux

    def fold_update(self, coeffs_all):
        """The per-point consumer over the pre-simulation coefficients."""

        def update(point_idx, ys, state, aux):
            with tracing.span("fold", point=point_idx):
                exp_j = int(self.exp_idx_tab[point_idx])
                if exp_j < 0:
                    return aux
                netted = self._netted_row(ys, point_idx, exp_j, coeffs_all)
                slot = int(self.stash_src_tab[exp_j])
                if self.n_slots and slot >= 0:
                    aux["stash"][slot] = netted
                m_i = int(self.metric_of_exp[exp_j])
                if m_i >= 0:
                    aux = self._on_metric(aux, netted, m_i, ys, point_idx)
                return aux

        return update

    # -- assembly ---------------------------------------------------------------

    def _date_errors(self, aux) -> None:
        """Each date's (mean, squared deviations) -> (mean, error), the
        squared deviations of every date summed over the ranks at once."""
        keys = [(kind, i) for kind in ("pos", "neg") for i in range(self.t_m)
                if aux[kind][i] is not None]
        if not keys:
            return
        sums = sum_over_ranks(torch.stack([aux[k][i][1] for k, i in keys]), self.sharding)
        for (k, i), err in zip(keys, sample_error(sums, self.n_global).unbind(0)):
            aux[k][i] = (aux[k][i][0], err)

    def assemble(self, aux):
        """Nested [ns][metric] -> [(value, err), ...] from the accumulators,
        each metric's own formulas and the CVA counterparty gate."""
        self._date_errors(aux)
        c = self.c
        nested = []
        for ns_idx, ns in enumerate(c.netting_sets):
            ns_results = []
            for metric in c.risk_metrics.metrics:
                mt = metric.metric_type
                if mt == MetricType.CE:
                    ns_results.append([(aux["pos"][0][0][ns_idx], aux["pos"][0][1][ns_idx])])
                elif mt == MetricType.EPE:
                    ns_results.append([(aux["pos"][i][0][ns_idx], aux["pos"][i][1][ns_idx])
                                       for i in range(self.t_m)])
                elif mt == MetricType.ENE:
                    ns_results.append([(aux["neg"][i][0][ns_idx], aux["neg"][i][1][ns_idx])
                                       for i in range(self.t_m)])
                elif mt == MetricType.EEPE:
                    per_date_ee = torch.stack([aux["pos"][i][0][ns_idx] for i in range(self.t_m)])
                    if getattr(metric, "effective", False):
                        per_date_ee = torch.cummax(per_date_ee, dim=0).values
                    ns_results.append([mc_mean_and_error(per_date_ee)])
                elif mt == MetricType.PFE:
                    p_idx = next(i for i, entry in enumerate(self.pfe_metrics)
                                 if entry[0] is metric)
                    _, _, pos, se_ks, q_index = self.pfe_metrics[p_idx]
                    rows = []
                    for i in range(self.t_m):
                        tab = aux["pfe"][p_idx][i][ns_idx]                 # [K]
                        lo, val, hi = tab[pos[se_ks[0]]], tab[pos[q_index]], tab[pos[se_ks[1]]]
                        if metric.pfe_se == "order-statistic":
                            err = (hi - lo) / 2.0
                        else:
                            err = metric._quantile_se(lo, val, hi, self.n_global, q_index)
                        rows.append((val, err))
                    ns_results.append(rows)
                elif mt == MetricType.CVA:
                    if (ns.counterparty_id is not None
                            and metric.counterparty_id != ns.counterparty_id):
                        ns_results.append(c._zero_metric_result(metric))
                        continue
                    c_idx = next(i for i, entry in enumerate(self.cva_metrics)
                                 if entry[0] is metric)
                    acc = aux["cva"][c_idx]
                    pathwise = (torch.zeros((self.num_paths,), dtype=real_dtype(),
                                            device=c.device) if acc is None else acc[ns_idx])
                    ns_results.append([mc_mean_and_error(pathwise * (1.0 - metric.recovery_rate),
                                                         self.sharding)])
                else:  # guarded by metric_stream_ineligibility
                    raise AssertionError(f"unsupported metric {mt}")
            nested.append(ns_results)
        return nested

    # -- coefficients ---------------------------------------------------------------

    def gather_coeffs(self, fits):
        """[T_exp, P, deg] exposure coefficients in netting-set-sorted product
        order, from the pre-simulation fits: the per-product fits (``fits``'
        exposure entries) and each batch's ``_exp_coeffs``."""
        cols = []
        for kind, ref in self._prod_sources:
            if kind == "plain":
                cols.append(fits["exposure"][ref.product_id][:, 0, :])
            else:
                batch, (asset, k) = ref
                cols.append(batch._exp_coeffs[asset][:, k, :])
        return torch.stack(cols, dim=1)

    def run(self, params, fits, noise_source=None, qmc_shift=None):
        """The main simulation with the fold: nested results."""
        from montecarlo_risk_engine_tpu_torch.engine.engine import simulate_paths

        c = self.c
        with tracing.span("stream", paths=c.num_paths_mainsim):
            aux = simulate_paths(
                c.model, params, c.simulation_scheme, c.simulation_timeline, c.num_paths_mainsim,
                c.num_steps, rng.PHASE_MAINSIM, root_seed=c.root_seed, noise_source=noise_source,
                antithetic=c.antithetic, sampler=c.sampler, qmc_bridge=c.qmc_bridge,
                remat=c.remat_paths, emit_schedule=self.schedule, collect_states=False,
                fold=(self._init_aux(), self.fold_update(self.gather_coeffs(fits))),
                qmc_shift=qmc_shift, device=c.device, path_sharding=self.sharding)
        with tracing.span("assemble"):
            return self.assemble(aux)
