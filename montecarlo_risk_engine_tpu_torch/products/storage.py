"""Gas storage: a daily-rollout dynamic program with a continuous inventory.

Counterpart of ``montecarlo_risk_engine_tpu/products/storage.py``: the
inventory lives on a [0, num_states - 1] grid in grid coordinates (a float
state; continuation lookups interpolate linearly between integer states,
storage.py:160-167); three actions per date (inject, hold, withdraw) with
volume-dependent ramp rates, volume windows tightened at construction by the
host optimizer (``storage_config.py``) and dated variable costs.  The greedy
argmax over the action values (payoff + interpolated continuation) stays
hard; gradients flow through the chosen branch's payoff.

Two steps with one rule, as in the JAX package: ``compute_normalized_cashflows``
(the per-date unrolled path, [N, S] states, date constants from the
configuration) and ``scan_exercise_step`` (the controller's event scan over a
bucket of products, [P, N, S] states, date constants from
``scan_event_extras`` rows).  Ties between action values (at a full or empty
store inject or withdraw and hold give the same volume) go to the first of
(inject, hold, withdraw), as ``jnp.argmax`` resolves them: the choice is made
by explicit comparisons, not by ``torch.argmax``.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch.config import real_dtype
from montecarlo_risk_engine_tpu_torch.products.base import Product, ProductFamily
from montecarlo_risk_engine_tpu_torch.products.storage_config import DATE_TOL, StorageConfig
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequest, AtomicRequestType
from montecarlo_risk_engine_tpu_torch.utils.maths import interp


class StorageAction(enum.Enum):
    INJECTION = 0
    WITHDRAWAL = 1
    DO_NOTHING = 2


def _first_argmax_select(values, *options):
    """The option at the first maximum of ``values`` (a list of equally
    shaped tensors), as ``jnp.argmax`` then ``take_along_axis`` pick it:
    a later value wins only if strictly greater."""
    best_value, best = values[0], list(options[0])
    for value, opt in zip(values[1:], options[1:]):
        better = value > best_value
        best_value = torch.where(better, value, best_value)
        best = [torch.where(better, o, b) for o, b in zip(opt, best)]
    return best


class Storage(Product):
    def __init__(self, asset_id: str, start_date: float, end_date: float, initial_amount: float,
                 storage_config: StorageConfig, num_states: int, rollout_interval: float = 1.0):
        super().__init__(asset_ids=[asset_id], product_family=ProductFamily.STORAGE_EXERCISE)
        if num_states < 2:
            raise ValueError("Storage requires at least two discrete states.")
        if rollout_interval <= 0.0:
            raise ValueError("Rollout interval must be positive.")

        self.start_date = float(start_date)
        self.end_date = float(end_date)
        self.initial_amount = float(initial_amount)
        self.storage_config = storage_config
        self.num_states = int(num_states)
        self.rollout_interval = float(rollout_interval)

        self.storage_config.optimize_volume_constraints(
            start_date=self.start_date, end_date=self.end_date,
            rollout_interval=self.rollout_interval, initial_volume=self.initial_amount)

        action_dates, next_dates = [], []
        date = self.start_date
        while date < self.end_date - DATE_TOL:
            next_date = min(date + self.rollout_interval, self.end_date)
            action_dates.append(date)
            next_dates.append(next_date)
            date = next_date

        self.product_timeline = tuple(action_dates)
        self.modeling_timeline = self.product_timeline
        self.regression_timeline = self.product_timeline
        self.next_action_dates = tuple(next_dates)

        self.numeraire_requests = {idx: AtomicRequest(AtomicRequestType.NUMERAIRE, t)
                                   for idx, t in enumerate(action_dates)}
        self.spot_requests = {(idx, asset_id): AtomicRequest(AtomicRequestType.SPOT)
                              for idx in range(len(action_dates))}

    def get_num_states(self):
        return self.num_states

    def get_initial_state(self):
        return 0.0

    def state_is_continuous(self):
        return True

    # -- grid/volume mapping (storage.py:98-156) ----------------------------------

    def _volume_from_state(self, state, vmin: float, vmax: float):
        step = self.storage_config.grid_step(vmin, vmax, self.num_states)
        return vmin + state.to(real_dtype()) * step

    def _state_from_volume(self, volume, vmin: float, vmax: float):
        scale = self.storage_config.state_scale(vmin, vmax, self.num_states)
        if scale == 0.0:
            return torch.zeros_like(volume)
        return (volume - vmin) * scale

    def _transition(self, date: float, next_date: float, action: StorageAction, state):
        """(previous volume, next volume) of an action (storage.py:110-129)."""
        cfg = self.storage_config
        prev_window = cfg.get_volume_constraint(date)
        next_window = cfg.get_volume_constraint(next_date)
        prev_volume = self._volume_from_state(state, prev_window.vmin, prev_window.vmax)
        period = max(next_date - date, 0.0)
        curve = lambda pts_rates: tuple(torch.tensor(a, dtype=prev_volume.dtype,
                                                     device=prev_volume.device)
                                        for a in cfg.rate_curve_arrays(pts_rates))

        if action == StorageAction.INJECTION:
            pts, rates = curve(cfg.get_injection_flexibility_slice(date))
            next_volume = torch.clamp(prev_volume + interp(prev_volume, pts, rates) * period,
                                      max=next_window.vmax)
        elif action == StorageAction.WITHDRAWAL:
            pts, rates = curve(cfg.get_withdrawal_flexibility_slice(date))
            next_volume = torch.clamp(prev_volume - interp(prev_volume, pts, rates) * period,
                                      min=next_window.vmin)
        else:
            next_volume = torch.clamp(prev_volume, next_window.vmin, next_window.vmax)
        return prev_volume, next_volume

    def state_to_volume(self, date: float, state):
        window = self.storage_config.get_volume_constraint(float(date))
        return self._volume_from_state(torch.as_tensor(state), window.vmin, window.vmax)

    def compute_next_state(self, date: float, next_date: float, action_type: StorageAction):
        """Mapping: previous grid state -> next grid state (storage.py:135-144)."""
        next_window = self.storage_config.get_volume_constraint(next_date)

        def mapping(previous_state):
            _, next_volume = self._transition(date, next_date, action_type,
                                              torch.as_tensor(previous_state))
            return self._state_from_volume(next_volume, next_window.vmin, next_window.vmax)

        return mapping

    def compute_volume_difference(self, date: float, next_date: float, action_type: StorageAction):
        """Mapping: previous grid state -> physical volume change (storage.py:146-156)."""

        def mapping(previous_state):
            prev_volume, next_volume = self._transition(date, next_date, action_type,
                                                        torch.as_tensor(previous_state))
            return next_volume - prev_volume

        return mapping

    # -- interpolating state lookup (storage.py:160-167) ----------------------------

    def lookup_state_values(self, values_by_state, state_matrix):
        """values_by_state [..., N, S] at the continuous states [..., N, K],
        linear between the integer states around each."""
        bounded = torch.clamp(state_matrix.to(real_dtype()), 0.0, self.num_states - 1.0)
        lower = torch.floor(bounded).long()
        upper = torch.ceil(bounded).long()
        weight = bounded - lower.to(real_dtype())
        lower_vals = torch.gather(values_by_state, -1, lower)
        upper_vals = torch.gather(values_by_state, -1, upper)
        return lower_vals + weight * (upper_vals - lower_vals)

    # -- the controller's event scan (storage.py:175-268) ----------------------------

    def scan_event_strikes(self):
        return [0.0] * len(self.product_timeline)

    def scan_bucket_statics(self):
        # every per-date number rides in scan_event_extras
        return ()

    @staticmethod
    def _padded_curves(slices):
        """[dates, max points] arrays of the curves, each padded by points
        beyond its last at its last rate (flat extrapolation unchanged)."""
        max_pts = max(len(s) for s in slices)
        pts = np.full((len(slices), max_pts), 0.0)
        rates = np.full((len(slices), max_pts), 0.0)
        for i, s in enumerate(slices):
            p = [rp.point for rp in s]
            r = [rp.rate for rp in s]
            while len(p) < max_pts:
                p.append(p[-1] + 1.0 + len(p))
                r.append(r[-1])
            pts[i] = p
            rates[i] = r
        return pts, rates

    def scan_event_extras(self):
        """{name: [num dates, ...] float64 array} of the step's per-date
        constants: windows, ramp curves, costs, period, last-date flag."""
        cfg = self.storage_config
        dates, next_dates = self.product_timeline, self.next_action_dates
        prev_win = [cfg.get_volume_constraint(d) for d in dates]
        next_win = [cfg.get_volume_constraint(d) for d in next_dates]
        inj_pts, inj_rates = self._padded_curves(
            [cfg.get_injection_flexibility_slice(d) for d in dates])
        wd_pts, wd_rates = self._padded_curves(
            [cfg.get_withdrawal_flexibility_slice(d) for d in dates])
        arr = lambda v: np.asarray(v, dtype=np.float64)
        return {
            "prev_vmin": arr([w.vmin for w in prev_win]),
            "prev_vmax": arr([w.vmax for w in prev_win]),
            "next_vmin": arr([w.vmin for w in next_win]),
            "next_vmax": arr([w.vmax for w in next_win]),
            "inj_pts": inj_pts, "inj_rates": inj_rates,
            "wd_pts": wd_pts, "wd_rates": wd_rates,
            "inj_cost": arr([cfg.get_variable_injection_cost(d) for d in dates]),
            "wd_cost": arr([cfg.get_variable_withdrawal_cost(d) for d in dates]),
            "period": arr([max(n - d, 0.0) for d, n in zip(dates, next_dates)]),
            "is_last": arr([1.0 if n >= self.end_date - DATE_TOL else 0.0 for n in next_dates]),
        }

    def scan_exercise_step(self, regression_function, state_matrix, underlying_value,
                           explanatory, numeraire, strike, coeffs, extras):
        """One DP date of a bucket: states [P, N, S], explanatory and
        numeraire [P, N], coeffs [P, S, deg], extras [P] scalars and [P, K]
        curves."""
        x = {k: v[:, None, None] for k, v in extras.items() if v.dim() == 1}
        spot = explanatory[..., None].expand(state_matrix.shape)
        s_minus_1 = self.num_states - 1.0

        prev_span = x["prev_vmax"] - x["prev_vmin"]
        prev_vol = x["prev_vmin"] + state_matrix.to(real_dtype()) * prev_span / s_minus_1
        next_span = torch.clamp(x["next_vmax"] - x["next_vmin"], min=1e-30)

        inj_rate = interp(prev_vol, extras["inj_pts"], extras["inj_rates"])
        wd_rate = interp(prev_vol, extras["wd_pts"], extras["wd_rates"])

        inj_vol = torch.minimum(prev_vol + inj_rate * x["period"], x["next_vmax"])
        wd_vol = torch.maximum(prev_vol - wd_rate * x["period"], x["next_vmin"])
        hold_vol = torch.minimum(torch.maximum(prev_vol, x["next_vmin"]), x["next_vmax"])

        vols = (inj_vol, hold_vol, wd_vol)
        states = [(v - x["next_vmin"]) * s_minus_1 / next_span for v in vols]
        deltas = [v - prev_vol for v in vols]
        hold_price = torch.where(deltas[1] >= 0.0, spot + x["inj_cost"], spot - x["wd_cost"])
        payoffs = [-deltas[0] * (spot + x["inj_cost"]), -deltas[1] * hold_price,
                   -deltas[2] * (spot - x["wd_cost"])]

        grid = self.evaluate_regression_grid(explanatory, regression_function, coeffs)
        continuations = [(1.0 - x["is_last"]) * self.lookup_state_values(grid, s) for s in states]
        values = [p + c for p, c in zip(payoffs, continuations)]
        next_state, cashflows = _first_argmax_select(values, *zip(states, payoffs))
        return next_state, cashflows / numeraire[..., None]

    # -- per-date DP step (storage.py:272-325) -----------------------------------------

    def compute_normalized_cashflows(self, time_idx, model, params, resolved_requests,
                                     regression_function=None, state_matrix=None):
        date = self.product_timeline[time_idx]
        next_date = self.next_action_dates[time_idx]
        next_window = self.storage_config.get_volume_constraint(next_date)

        spot = self.get_resolved_atomic_request(resolved_requests[0], AtomicRequestType.SPOT,
                                                time_idx, self.get_asset_id())
        spot_col = spot[:, None].expand(state_matrix.shape)
        inj_cost = self.storage_config.get_variable_injection_cost(date)
        wd_cost = self.storage_config.get_variable_withdrawal_cost(date)

        states, payoffs = [], []
        for action in (StorageAction.INJECTION, StorageAction.DO_NOTHING, StorageAction.WITHDRAWAL):
            prev_vol, next_vol = self._transition(date, next_date, action, state_matrix)
            delta = next_vol - prev_vol
            if action == StorageAction.INJECTION:
                payoff = -delta * (spot_col + inj_cost)
            elif action == StorageAction.WITHDRAWAL:
                payoff = -delta * (spot_col - wd_cost)
            else:
                payoff = -delta * torch.where(delta >= 0.0, spot_col + inj_cost, spot_col - wd_cost)
            states.append(self._state_from_volume(next_vol, next_window.vmin, next_window.vmax))
            payoffs.append(payoff)

        if next_date >= self.end_date - DATE_TOL or self.regression_coeffs is None:
            continuations = [torch.zeros_like(p) for p in payoffs]
        else:
            grid = self.evaluate_regression_grid(spot, regression_function,
                                                 self.regression_coeffs[time_idx])
            continuations = [self.lookup_state_values(grid, s) for s in states]

        values = [p + c for p, c in zip(payoffs, continuations)]
        next_state, cashflows = _first_argmax_select(values, *zip(states, payoffs))
        numeraire = self.get_resolved_atomic_request(resolved_requests[0],
                                                     AtomicRequestType.NUMERAIRE, time_idx)
        numeraire_col = numeraire[:, None] if numeraire.dim() == 1 else numeraire
        return next_state, cashflows / numeraire_col
