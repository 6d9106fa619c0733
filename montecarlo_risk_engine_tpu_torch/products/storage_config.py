"""Gas-storage configuration: volume windows, flexibility curves, costs.

Counterpart of ``montecarlo_risk_engine_tpu/products/storage_config.py``, a
copy in plain Python (the port imports nothing of the JAX package).  All of
it is set-up code on the host: the constraint-propagation optimizer runs
plain bisection, and :meth:`StorageConfig.rate_curve_arrays` exports a
flexibility curve as static tuples for the storage step's interpolation on
the device.  ``optimize_volume_constraints`` gives the JAX package's windows
exactly: the same float operations in the same order.
"""

from __future__ import annotations

import math
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field
from typing import List, Tuple


DATE_TOL = 1e-12
VOLUME_TOL = 1e-12


@dataclass
class RatePoint:
    point: float
    rate: float


@dataclass
class RateSchedule:
    start_date: float
    end_date: float
    values: List[RatePoint] = field(default_factory=list)

    def contains(self, date: float) -> bool:
        return StorageConfig._date_in_window(self.start_date, self.end_date, date)


@dataclass
class VolumeWindow:
    start_date: float
    end_date: float
    vmin: float
    vmax: float
    penalty: float = 0.0

    def contains(self, date: float) -> bool:
        return StorageConfig._date_in_window(self.start_date, self.end_date, date)


@dataclass
class DatedCost:
    date: float
    cost: float


class StorageConfig:
    """The schedules may come as data: each keyword takes rows of numbers
    (lists, or a float64 matrix) and adds them through the ``add_*`` method
    of its kind, row by row in the given order, as a caller of those methods
    would:

      * ``volume_constraints``: (start, end, vmin, vmax[, penalty]);
      * ``injection_flexibility``, ``withdrawal_flexibility``: (start, end,
        volume point, rate);
      * ``injection_costs``, ``withdrawal_costs``: (date, cost).

    Without them the configuration starts empty."""

    def __init__(self, volume_constraints=(), injection_flexibility=(), withdrawal_flexibility=(),
                 injection_costs=(), withdrawal_costs=()):
        self.initial_volume_constraints: List[VolumeWindow] = []
        self.volume_constraints: List[VolumeWindow] = []
        self.injection_flexibility: List[RateSchedule] = []
        self.withdrawal_flexibility: List[RateSchedule] = []
        self.injection_costs: List[DatedCost] = []
        self.withdrawal_costs: List[DatedCost] = []
        for rows, add in ((volume_constraints, self.add_volume_constraint),
                          (injection_flexibility, self.add_injection_flexibility),
                          (withdrawal_flexibility, self.add_withdrawal_flexibility),
                          (injection_costs, self.add_variable_injection_cost),
                          (withdrawal_costs, self.add_variable_withdrawal_cost)):
            for row in rows:
                add(*row)

    # -- window/grid helpers (storage_helpers.py:50-66) -------------------------

    @staticmethod
    def _date_in_window(start: float, end: float, date: float) -> bool:
        if math.isclose(start, end, abs_tol=DATE_TOL):
            return math.isclose(start, date, abs_tol=DATE_TOL)
        return (start - DATE_TOL) <= date < (end - DATE_TOL)

    @staticmethod
    def grid_step(vmin: float, vmax: float, num_states: int) -> float:
        if num_states <= 1 or math.isclose(vmin, vmax, abs_tol=VOLUME_TOL):
            return 0.0
        return (vmax - vmin) / (num_states - 1.0)

    @staticmethod
    def state_scale(vmin: float, vmax: float, num_states: int) -> float:
        if num_states <= 1 or math.isclose(vmin, vmax, abs_tol=VOLUME_TOL):
            return 0.0
        return (num_states - 1.0) / (vmax - vmin)

    # -- declaration API (storage_helpers.py:140-285) -----------------------------

    def add_volume_constraint(self, start_date, end_date, vmin, vmax, penalty=0.0) -> None:
        self.initial_volume_constraints.append(
            VolumeWindow(float(start_date), float(end_date), float(vmin), float(vmax), float(penalty))
        )
        self.initial_volume_constraints.sort(key=lambda w: w.start_date)

    def add_injection_flexibility(self, start_date, end_date, point, rate) -> None:
        self._add_rate(self.injection_flexibility, start_date, end_date, point, rate)

    def add_withdrawal_flexibility(self, start_date, end_date, point, rate) -> None:
        self._add_rate(self.withdrawal_flexibility, start_date, end_date, point, rate)

    def add_variable_injection_cost(self, date, cost) -> None:
        self.injection_costs.append(DatedCost(float(date), float(cost)))
        self.injection_costs.sort(key=lambda c: c.date)

    def add_variable_withdrawal_cost(self, date, cost) -> None:
        self.withdrawal_costs.append(DatedCost(float(date), float(cost)))
        self.withdrawal_costs.sort(key=lambda c: c.date)

    @staticmethod
    def _add_rate(container, start_date, end_date, point, rate) -> None:
        start_date, end_date = float(start_date), float(end_date)
        for schedule in container:
            if math.isclose(schedule.start_date, start_date, abs_tol=DATE_TOL) and math.isclose(
                schedule.end_date, end_date, abs_tol=DATE_TOL
            ):
                schedule.values.append(RatePoint(float(point), float(rate)))
                schedule.values.sort(key=lambda p: p.point)
                return
        container.append(RateSchedule(start_date, end_date, [RatePoint(float(point), float(rate))]))
        container.sort(key=lambda s: s.start_date)

    # -- lookups -------------------------------------------------------------------

    def _window_at(self, date: float, constraints: List[VolumeWindow]) -> VolumeWindow:
        for window in constraints:
            if window.contains(date):
                return window
        if not constraints:
            raise ValueError("No volume constraints configured.")
        return constraints[-1]

    def get_initial_volume_constraint(self, date: float) -> VolumeWindow:
        return self._window_at(date, self.initial_volume_constraints)

    def get_volume_constraint(self, date: float) -> VolumeWindow:
        return self._window_at(date, self.volume_constraints or self.initial_volume_constraints)

    def _schedule_at(self, date: float, container: List[RateSchedule]) -> List[RatePoint]:
        for schedule in container:
            if schedule.contains(date):
                return schedule.values
        if not container:
            raise ValueError("No flexibility slice configured.")
        return container[-1].values

    def get_injection_flexibility_slice(self, date: float) -> List[RatePoint]:
        return self._schedule_at(date, self.injection_flexibility)

    def get_withdrawal_flexibility_slice(self, date: float) -> List[RatePoint]:
        return self._schedule_at(date, self.withdrawal_flexibility)

    @staticmethod
    def interpolate_rate(point: float, rate_points: List[RatePoint]) -> float:
        """Host scalar interpolation (storage_helpers.py:67-95): linear
        interior, flat extrapolation."""
        if not rate_points:
            raise ValueError("Flexibility slice is empty.")
        if len(rate_points) == 1:
            return rate_points[0].rate
        xs = [p.point for p in rate_points]
        ys = [p.rate for p in rate_points]
        if point <= xs[0]:
            return ys[0]
        if point >= xs[-1]:
            return ys[-1]
        hi = bisect_right(xs, point)
        lo = hi - 1
        if math.isclose(xs[lo], xs[hi], abs_tol=VOLUME_TOL):
            return ys[hi]
        w = (point - xs[lo]) / (xs[hi] - xs[lo])
        return ys[lo] + w * (ys[hi] - ys[lo])

    def get_injection_flexibility_rate(self, date: float, point: float) -> float:
        return self.interpolate_rate(point, self.get_injection_flexibility_slice(date))

    def get_withdrawal_flexibility_rate(self, date: float, point: float) -> float:
        return self.interpolate_rate(point, self.get_withdrawal_flexibility_slice(date))

    @staticmethod
    def rate_curve_arrays(rate_points: List[RatePoint]) -> Tuple[tuple, tuple]:
        """Static (points, rates) tuples for the device-side interpolation."""
        if len(rate_points) == 1:
            p = rate_points[0]
            return (p.point, p.point + 1.0), (p.rate, p.rate)
        return (
            tuple(p.point for p in rate_points),
            tuple(p.rate for p in rate_points),
        )

    def _cost_at(self, date: float, container: List[DatedCost]) -> float:
        # Piecewise-previous lookup (storage_helpers.py:253-270).
        if not container:
            raise ValueError("No variable costs configured.")
        dates = [c.date for c in container]
        lower = bisect_left(dates, date)
        if lower == len(container):
            return container[-1].cost
        if lower == 0 or math.isclose(container[lower].date, date, abs_tol=DATE_TOL):
            return container[lower].cost
        return container[lower - 1].cost

    def get_variable_injection_cost(self, date: float) -> float:
        return self._cost_at(date, self.injection_costs)

    def get_variable_withdrawal_cost(self, date: float) -> float:
        return self._cost_at(date, self.withdrawal_costs)

    # -- constraint propagation optimizer (storage_helpers.py:287-437) ---------------

    def _tighten_boundary(self, date_i, period, index, optimize_vmax, constraints) -> None:
        """Bisection-tighten window ``index`` so window ``index+1`` stays
        reachable with the available injection/withdrawal flexibility."""
        if optimize_vmax:
            target = constraints[index + 1].vmax
            lo, hi = target, constraints[index].vmax
            threshold = (hi - lo) / 1000.0
            while hi - lo > threshold:
                mid = lo + 0.5 * (hi - lo)
                reachable = mid - self.get_withdrawal_flexibility_rate(date_i, mid) * period
                if reachable <= target:
                    lo = mid
                else:
                    hi = mid
            constraints[index].vmax = lo
            return

        target = constraints[index + 1].vmin
        hi, lo = target, constraints[index].vmin
        threshold = (hi - lo) / 1000.0
        while hi - lo > threshold:
            mid = hi - 0.5 * (hi - lo)
            reachable = mid + self.get_injection_flexibility_rate(date_i, mid) * period
            if reachable <= target:
                lo = mid
            else:
                hi = mid
        constraints[index].vmin = hi

    def optimize_volume_constraints(self, start_date, end_date, rollout_interval, initial_volume) -> None:
        """Forward reachability tightening with restart loop; raises on
        infeasible initial constraints (storage_helpers.py:287-437)."""
        dates: List[float] = []
        initial: List[VolumeWindow] = []
        optimized: List[VolumeWindow] = []

        date = float(start_date)
        while date <= end_date + DATE_TOL:
            next_date = min(date + rollout_interval, end_date)
            window = self.get_initial_volume_constraint(date)
            vmin, vmax = window.vmin, window.vmax
            if math.isclose(date, start_date, abs_tol=DATE_TOL):
                vmin = vmax = float(initial_volume)
            initial.append(window)
            optimized.append(VolumeWindow(date, next_date, vmin, vmax, window.penalty))
            dates.append(date)
            if date >= end_date - DATE_TOL:
                break
            date = next_date

        restart = True
        while restart:
            restart = False
            for i in range(len(optimized) - 1):
                date_i = optimized[i].start_date
                period = dates[i + 1] - dates[i]
                vmax_i, vmax_n = optimized[i].vmax, optimized[i + 1].vmax
                vmin_i, vmin_n = optimized[i].vmin, optimized[i + 1].vmin

                wd_at_vmax = self.get_withdrawal_flexibility_rate(date_i, vmax_i) * period
                wd_at_vmin = self.get_withdrawal_flexibility_rate(date_i, vmin_i) * period
                inj_at_vmax = self.get_injection_flexibility_rate(date_i, vmax_i) * period
                inj_at_vmin = self.get_injection_flexibility_rate(date_i, vmin_i) * period

                if vmax_i < vmax_n:
                    if vmax_i + inj_at_vmax < vmax_n:
                        optimized[i + 1].vmax = vmax_i + inj_at_vmax
                else:
                    if vmax_i - wd_at_vmax > vmax_n:
                        self._tighten_boundary(date_i, period, i, True, optimized)
                        restart = True

                if vmin_i < vmin_n:
                    if vmin_i + inj_at_vmin < vmin_n:
                        self._tighten_boundary(date_i, period, i, False, optimized)
                        restart = True
                else:
                    if vmin_i - wd_at_vmin > vmin_n:
                        optimized[i + 1].vmin = vmin_i - wd_at_vmin

                violated_i = (
                    optimized[i].vmin > initial[i].vmax or optimized[i].vmax < initial[i].vmin
                )
                violated_n = (
                    optimized[i + 1].vmin > initial[i + 1].vmax
                    or optimized[i + 1].vmax < initial[i + 1].vmin
                )
                if violated_i or violated_n:
                    bad_date = dates[i] if violated_i else dates[i + 1]
                    raise ValueError(
                        f"Initial volume constraints cannot be satisfied at date {bad_date}."
                    )
                if restart:
                    break

        self.volume_constraints = optimized
