"""Plain reference of the mixed PV book: the PV of one netting set of eight
product families on one multi-asset Black-Scholes model.

The book: European calls and puts, binaries (cash or nothing), arithmetic
and geometric baskets, arithmetic and geometric Asians, up-and-out
barriers, Americans and FlexiCalls (a strip of calls with k exercise
rights) by Longstaff-Schwartz, and gas-storage deals by the LSM dynamic
programme over a volume grid.  Identical products (the book cycles its
fields) are valued once and counted.

Paths: the configuration states float32 paths for both phases, the
pre-simulation (Philox phase 42, where the regressions are fitted) and the
main simulation (phase 43, where everything is valued), on the timeline of
every observation date of the book, one exact substep a date, op for op as
``bs_multi_euro_book.py`` states them (a date at the calibration date keeps
exp(log S0)).  Valuation is float64; the numeraire is exp(r t).

Semantics, each as the port's method fixes it (where stated):
  * binary: the payment times the ramp clamp((S - K + 1) / 2, 0, 1), its
    complement for a put (the port's binary_option.py: a ramp of width 1);
  * basket: sum w S, or exp(sum w log(S + 1e-10)); Asian: the mean of S over
    linspace(start, maturity, n), or exp(mean(log(S + 1e-10)));
  * up-and-out barrier: the vanilla payoff times clamp((B - max S + 0.05) /
    0.1, 0, 1) over the monitoring dates (barrier_option.py: a fuzzy
    indicator of width 0.05);
  * Americans exercise on linspace(0, maturity, n), FlexiCalls on their
    strip's dates, with rights + 1 states; storage acts on start, start +
    dt, ... up to the end; every decision compares the immediate value with
    the continuation of a degree-2 polynomial basis [1, x, x^2] in the
    asset's spot, fitted on the pre-simulation from the last date back and
    applied on the main paths (utils/regression.py: columns scaled to unit
    RMS, normal equations, a ridge of 1e-10 of the mean Gram diagonal; every
    path in the fit: the book asks for no in-the-money filter);
  * an American exercises when immediate > continuation and a right is
    left; a FlexiCall when immediate + continuation(state - 1) >
    continuation(state); the last date's continuation is a fit of zeros;
  * storage: the windows by forward constraint propagation from the
    initial volume (bisection to a thousandth, restart after a tightening,
    storage_config.py), flexibility and costs looked up per date (a window
    or slice covers [start, end); costs piecewise previous); per date the
    actions inject, hold and withdraw from each grid state at the
    interpolated rate, clamped to the next window; the payoff is -dV (S +
    injection cost), -dV (S - withdrawal cost), hold priced by its sign;
    the continuation is interpolated linearly between the grid states; the
    first maximum among (inject, hold, withdraw) wins a tie (storage.py).

Departures: none in what is computed.  The book's barriers carry no
Brownian-bridge correction (the upstream script never turns it on), so
the bridge stream is not drawn.  Sums over paths and products are plain
float64 sums, the linear solves ``torch.linalg.solve``: they round apart
from the port's fixed trees and LU solves by about 1e-16 relative.

Compared number (the worst over the sampled runs):
  * ``pv_gap``: |PV - PV_ref| / |PV_ref|.
"""

from __future__ import annotations

import json
import math
from bisect import bisect_left
from typing import Dict, List

import numpy as np
import torch

from riskbench import book, counting
from riskbench.reference import philox

F32, F64 = torch.float32, torch.float64
DATE_TOL = 1e-12  # storage windows and dates (storage_config.py)
VOLUME_TOL = 1e-12
DEGREE = 3  # basis columns [1, x, x^2]
RIDGE = 1e-10  # of the mean Gram diagonal, in float64
EXERCISE = ("AmericanOption", "FlexiCall", "Storage")


def model_parts(cfg):
    m = cfg["model"]
    return (list(m["asset_ids"]), [float(s) for s in m["spots"]],
            [float(v) for v in m["volatilities"]], float(m["rate"]),
            np.asarray(m["correlation_matrix"], dtype=np.float64))


def distinct_products(cfg):
    """[(fields, count)] of the book's distinct products, in book order."""
    seen: Dict[str, list] = {}
    for ns in book.netting_set_products(cfg):
        for p in ns:
            key = json.dumps(p, sort_keys=True)
            if key in seen:
                seen[key][1] += 1
            else:
                seen[key] = [p, 1]
    return [tuple(v) for v in seen.values()]


def _enum(v):
    return v["value"]


# -- dates -----------------------------------------------------------------------------


def storage_dates(p):
    """(action dates, next dates) of a storage deal: start, start + dt, ..."""
    dates, nexts, date = [], [], float(p["start_date"])
    end, step = float(p["end_date"]), float(p["rollout_interval"])
    while date < end - DATE_TOL:
        nxt = min(date + step, end)
        dates.append(date)
        nexts.append(nxt)
        date = nxt
    return dates, nexts


def flexi_strip(p):
    """[(date, strike)] of a FlexiCall's calls in date order."""
    return sorted((float(o["exercise_date"]), float(o["strike"])) for o in p["underlyings"])


def observation_dates(p) -> List[float]:
    kind = p["type"]
    if kind == "EuropeanOption":
        return [float(p["exercise_date"])]
    if kind in ("BinaryOption", "BasketOption"):
        return [float(p["maturity"])]
    if kind in ("AsianOption", "BarrierOption"):
        return [float(t) for t in np.linspace(p["startdate"], p["maturity"],
                                              p["num_observation_timepoints"])]
    if kind == "AmericanOption":
        n = int(p["num_exercise_dates"])
        return ([float(t) for t in np.linspace(0.0, p["maturity"], n)] if n > 1
                else [float(p["maturity"])])
    if kind == "FlexiCall":
        return [t for t, _ in flexi_strip(p)]
    if kind == "Storage":
        return storage_dates(p)[0]
    raise ValueError(f"no reference for {kind}")


def timeline(cfg) -> List[float]:
    return sorted({t for p, _ in distinct_products(cfg) for t in observation_dates(p)})


def path_launches(cfg, traffic) -> List[counting.Launch]:
    """The path launches of one run: the pre-simulation, then the main one."""
    assets, _, _, _, corr = model_parts(cfg)
    blocks = (counting.Block("bs_multi", "exact", len(assets)),)
    return [counting.Launch(blocks, np.linalg.cholesky(corr), tuple(timeline(cfg)),
                            int(cfg["num_steps"]), int(traffic[k]))
            for k in ("num_paths_presim", "num_paths")]


# -- paths -------------------------------------------------------------------------------


def paths(seed: int, phase: int, num_paths: int, cfg, times, device) -> torch.Tensor:
    """S [T, N, A] float32 at every date of ``times`` for paths 0 .. N - 1:
    per substep of length dt, w = L z (z the substep's Philox normals, L
    the correlation's Cholesky factor, float32, summed left to right), log S
    += (r - s^2 / 2) dt + s sqrt(dt) w, S = exp(log S) at each date."""
    _, spots, vols, rate, corr = model_parts(cfg)
    chol32 = np.linalg.cholesky(corr).astype(np.float32)
    num_steps, n_a = int(cfg["num_steps"]), len(spots)
    idx = torch.arange(num_paths, dtype=torch.int64, device=device)
    f32 = lambda v: torch.tensor(v, dtype=F64, device=device).to(F32)  # noqa: E731
    sig, r32 = [f32(v) for v in vols], f32(rate)
    log_s = [torch.log(torch.tensor(s, dtype=F64, device=device)).to(F32).expand(num_paths)
             for s in spots]
    out, t_prev = [], 0.0
    for i, t in enumerate(times):
        if t > t_prev:
            dt = (t - t_prev) / num_steps
            dt32, sq32 = f32(dt), f32(np.sqrt(dt))
            for k in range(num_steps):
                z = philox.normals(seed, phase, i * num_steps + k, idx, n_a, F32)
                w = []
                for a in range(n_a):
                    acc = float(chol32[a, 0]) * z[:, 0]
                    for e in range(1, a + 1):
                        acc = acc + float(chol32[a, e]) * z[:, e]
                    w.append(acc)
                for a in range(n_a):
                    drift = (r32 - 0.5 * sig[a] * sig[a]) * dt32
                    log_s[a] = log_s[a] + drift + sig[a] * sq32 * w[a]
        t_prev = t
        out.append(torch.stack([torch.exp(x) for x in log_s], dim=-1))
    return torch.stack(out)


class Phase:
    """One phase's spots and numeraires by date and asset, float64."""

    def __init__(self, states32: torch.Tensor, times, assets, rate: float):
        self.states = states32
        self.row = {t: i for i, t in enumerate(times)}
        self.col = {a: i for i, a in enumerate(assets)}
        self.rate = torch.tensor(rate, dtype=F64, device=states32.device)

    def spot(self, t: float, asset: str) -> torch.Tensor:
        return self.states[self.row[t], :, self.col[asset]].to(F64)

    def numeraire(self, t: float) -> torch.Tensor:
        t = torch.tensor(t, dtype=F64, device=self.states.device)
        return torch.exp(self.rate * t).expand(self.states.shape[1])


# -- terminal families -----------------------------------------------------------------


def _sign(option_type) -> float:
    return 1.0 if _enum(option_type) == "CALL" else -1.0


def terminal_cashflows(p, ph: Phase) -> torch.Tensor:
    """Deflated cashflows [N] of a product with one payment."""
    kind = p["type"]
    if kind == "EuropeanOption":
        t = float(p["exercise_date"])
        s = ph.spot(t, p["underlying"]["asset_id"])
        pay = torch.clamp(_sign(p["option_type"]) * (s - float(p["strike"])), min=0.0)
    elif kind == "BinaryOption":
        t = float(p["maturity"])
        above = torch.clamp((ph.spot(t, p["asset_id"]) - float(p["strike"]) + 1.0) / 2.0, 0.0, 1.0)
        pay = float(p["payment_amount"]) * (above if _enum(p["option_type"]) == "CALL"
                                            else 1.0 - above)
    elif kind == "BasketOption":
        t = float(p["maturity"])
        s = [ph.spot(t, a) for a in p["asset_ids"]]
        w = [float(x) for x in p["weights"]]
        if _enum(p["basket_option_type"]) == "GEOMETRIC":
            basket = torch.exp(sum(wi * torch.log(si + 1e-10) for wi, si in zip(w, s)))
        else:
            basket = sum(wi * si for wi, si in zip(w, s))
        pay = torch.clamp(_sign(p["option_type"]) * (basket - float(p["strike"])), min=0.0)
    elif kind in ("AsianOption", "BarrierOption"):
        dates = observation_dates(p)
        s = torch.stack([ph.spot(d, p["asset_id"]) for d in dates])  # [O, N]
        t = dates[-1]
        if kind == "AsianOption":
            geometric = _enum(p["averaging_type"]) == "GEOMETRIC"
            avg = torch.exp(torch.log(s + 1e-10).mean(0)) if geometric else s.mean(0)
            pay = torch.clamp(_sign(p["option_type"]) * (avg - float(p["strike"])), min=0.0)
        else:
            if _enum(p["barrier_option_type1"]) != "UPANDOUT" or p.get("barrier2") is not None:
                raise ValueError("the reference values one up-and-out barrier")
            survive = torch.clamp((float(p["barrier1"]) - s.max(0).values + 0.05) / 0.1, 0.0, 1.0)
            pay = torch.clamp(_sign(p["option_type"]) * (s[-1] - float(p["strike"])),
                              min=0.0) * survive
    else:
        raise ValueError(f"{kind} is not a terminal product")
    return pay / ph.numeraire(t)


# -- least squares -------------------------------------------------------------------------


def basis(x: torch.Tensor) -> torch.Tensor:
    return torch.stack([x ** k for k in range(DEGREE)], dim=-1)


def fit(x: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Coefficients [S, 3] of targets [N, S] on the basis of x [N]: columns
    scaled to unit RMS, the normal equations with a ridge of RIDGE times
    the mean diagonal, the scale undone."""
    a = basis(x)
    n = a.shape[0]
    scale = torch.clamp(torch.sqrt((a * a).sum(0) / n), min=1e-30)
    a = a / scale
    gram = a.T @ a
    rhs = a.T @ targets
    gram = gram + (RIDGE * torch.diagonal(gram).sum() / DEGREE + 1e-30) * torch.eye(
        DEGREE, dtype=F64, device=x.device)
    return (torch.linalg.solve(gram, rhs) / scale[:, None]).T


def continuation(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """[N, S] continuation values of every state, the basis columns' terms
    summed in order."""
    a = basis(x)
    out = a[:, 0, None] * coeffs[None, :, 0]
    for k in range(1, DEGREE):
        out = out + a[:, k, None] * coeffs[None, :, k]
    return out


# -- Americans and FlexiCalls ------------------------------------------------------------------


def exercise_terms(p):
    """(dates, strikes, sign, rights, flexi)."""
    if p["type"] == "AmericanOption":
        dates = observation_dates(p)
        return dates, [float(p["strike"])] * len(dates), _sign(p["option_type"]), 1, False
    strip = flexi_strip(p)
    sign = _sign(p["underlyings"][0]["option_type"])
    return ([t for t, _ in strip], [k for _, k in strip], sign, int(p["num_exercise_rights"]),
            True)


def option_lsm(p, pre: Phase, main: Phase) -> torch.Tensor:
    """Deflated cashflows [N] of an American or a FlexiCall on the main
    paths, its policy fitted on the pre-simulation."""
    dates, strikes, sign, rights, flexi = exercise_terms(p)
    asset = p["asset_id"]
    s_count = rights + 1
    dev = pre.states.device
    down = torch.clamp(torch.arange(s_count, device=dev) - 1, min=0)  # the state after exercise
    alive = torch.arange(s_count, device=dev) > 0
    carry = torch.zeros((pre.states.shape[1], s_count), dtype=F64, device=dev)
    coeffs = [None] * len(dates)
    for e in reversed(range(len(dates))):
        x, num = pre.spot(dates[e], asset), pre.numeraire(dates[e])
        coeffs[e] = fit(x, num[:, None] * carry)
        grid = continuation(x, coeffs[e])
        now = torch.clamp(sign * (x - strikes[e]), min=0.0)[:, None]
        gain = now + grid[:, down] if flexi else now
        ex = (gain > grid) & alive
        carry = now * ex.to(F64) / num[:, None] + torch.where(ex, carry[:, down], carry)
    state = torch.full((main.states.shape[1],), rights, dtype=torch.long, device=dev)
    cash = torch.zeros(main.states.shape[1], dtype=F64, device=dev)
    for e in range(len(dates)):
        x, num = main.spot(dates[e], asset), main.numeraire(dates[e])
        grid = continuation(x, coeffs[e])
        hold = grid.gather(1, state[:, None])[:, 0]
        now = torch.clamp(sign * (x - strikes[e]), min=0.0)
        gain = now + grid.gather(1, torch.clamp(state - 1, min=0)[:, None])[:, 0] if flexi else now
        ex = (gain > hold) & (state > 0)
        cash = cash + now * ex.to(F64) / num
        state = state - ex.long()
    return cash


# -- gas storage ---------------------------------------------------------------------------


def _in_window(start: float, end: float, date: float) -> bool:
    if math.isclose(start, end, abs_tol=DATE_TOL):
        return math.isclose(start, date, abs_tol=DATE_TOL)
    return (start - DATE_TOL) <= date < (end - DATE_TOL)


def _first_covering(items, date):
    for it in items:
        if _in_window(it[0], it[1], date):
            return it
    return items[-1]


def _rate(point: float, curve) -> float:
    """A flexibility curve [(volume, rate)] at one volume: linear inside,
    flat outside."""
    if len(curve) == 1:
        return curve[0][1]
    xs, ys = [c[0] for c in curve], [c[1] for c in curve]
    if point <= xs[0]:
        return ys[0]
    if point >= xs[-1]:
        return ys[-1]
    hi = next(i for i, x in enumerate(xs) if x > point)
    lo = hi - 1
    if math.isclose(xs[lo], xs[hi], abs_tol=VOLUME_TOL):
        return ys[hi]
    return ys[lo] + (point - xs[lo]) / (xs[hi] - xs[lo]) * (ys[hi] - ys[lo])


class StorageTerms:
    """A deal's windows, curves and costs from its configuration rows."""

    def __init__(self, p):
        c = p["storage_config"]
        self.initial = sorted(([float(x) for x in r] + [0.0] * (5 - len(r))
                               for r in c["volume_constraints"]), key=lambda w: w[0])
        self.inj = self._curves(c["injection_flexibility"])
        self.wd = self._curves(c["withdrawal_flexibility"])
        self.inj_cost = sorted(((float(d), float(k)) for d, k in c["injection_costs"]),
                               key=lambda x: x[0])
        self.wd_cost = sorted(((float(d), float(k)) for d, k in c["withdrawal_costs"]),
                              key=lambda x: x[0])
        self.dates, self.nexts = storage_dates(p)
        self.end = float(p["end_date"])
        self.windows = self._propagate(float(p["start_date"]), self.end,
                                       float(p["rollout_interval"]), float(p["initial_amount"]))

    @staticmethod
    def _curves(rows):
        """[(start, end, [(volume, rate)] by volume)] by start, rows of one
        (start, end) merged."""
        out = []
        for start, end, point, rate in ((float(x) for x in r) for r in rows):
            for c in out:
                if math.isclose(c[0], start, abs_tol=DATE_TOL) and math.isclose(
                        c[1], end, abs_tol=DATE_TOL):
                    c[2].append((point, rate))
                    c[2].sort(key=lambda x: x[0])
                    break
            else:
                out.append((start, end, [(point, rate)]))
                out.sort(key=lambda c: c[0])
        return out

    def inj_curve(self, date):
        return _first_covering(self.inj, date)[2]

    def wd_curve(self, date):
        return _first_covering(self.wd, date)[2]

    @staticmethod
    def _cost(costs, date: float) -> float:
        dates = [d for d, _ in costs]
        i = bisect_left(dates, date)
        if i == len(costs):
            return costs[-1][1]
        if i == 0 or math.isclose(costs[i][0], date, abs_tol=DATE_TOL):
            return costs[i][1]
        return costs[i - 1][1]

    def window(self, date: float):
        """[start, end, vmin, vmax] of the propagated window at a date."""
        return _first_covering(self.windows, date)

    def _propagate(self, start, end, step, initial):
        """The reachable volume windows, one per date, tightened forward
        from the initial volume until no window changes."""
        dates, init, win = [], [], []
        date = start
        while date <= end + DATE_TOL:
            nxt = min(date + step, end)
            w = _first_covering(self.initial, date)
            lo, hi = w[2], w[3]
            if math.isclose(date, start, abs_tol=DATE_TOL):
                lo = hi = initial
            init.append(w)
            win.append([date, nxt, lo, hi])
            dates.append(date)
            if date >= end - DATE_TOL:
                break
            date = nxt
        restart = True
        while restart:
            restart = False
            for i in range(len(win) - 1):
                d, period = win[i][0], dates[i + 1] - dates[i]
                hi_i, hi_n, lo_i, lo_n = win[i][3], win[i + 1][3], win[i][2], win[i + 1][2]
                wd_hi = _rate(hi_i, self.wd_curve(d)) * period
                wd_lo = _rate(lo_i, self.wd_curve(d)) * period
                inj_hi = _rate(hi_i, self.inj_curve(d)) * period
                inj_lo = _rate(lo_i, self.inj_curve(d)) * period
                if hi_i < hi_n:
                    if hi_i + inj_hi < hi_n:
                        win[i + 1][3] = hi_i + inj_hi
                elif hi_i - wd_hi > hi_n:
                    self._tighten(d, period, win, i, True)
                    restart = True
                if lo_i < lo_n:
                    if lo_i + inj_lo < lo_n:
                        self._tighten(d, period, win, i, False)
                        restart = True
                elif lo_i - wd_lo > lo_n:
                    win[i + 1][2] = lo_i - wd_lo
                bad = lambda k: win[k][2] > init[k][3] or win[k][3] < init[k][2]  # noqa: E731
                if bad(i) or bad(i + 1):
                    raise ValueError("storage windows cannot be met")
                if restart:
                    break
        return win

    def _tighten(self, d, period, win, i, upper: bool):
        """Bisect window i's bound so window i + 1's stays reachable."""
        if upper:
            target = win[i + 1][3]
            lo, hi = target, win[i][3]
            threshold = (hi - lo) / 1000.0
            while hi - lo > threshold:
                mid = lo + 0.5 * (hi - lo)
                if mid - _rate(mid, self.wd_curve(d)) * period <= target:
                    lo = mid
                else:
                    hi = mid
            win[i][3] = lo
            return
        target = win[i + 1][2]
        hi, lo = target, win[i][2]
        threshold = (hi - lo) / 1000.0
        while hi - lo > threshold:
            mid = hi - 0.5 * (hi - lo)
            if mid + _rate(mid, self.inj_curve(d)) * period <= target:
                lo = mid
            else:
                hi = mid
        win[i][2] = hi

    def at(self, e: int):
        """The constants of action date e."""
        d, n = self.dates[e], self.nexts[e]
        prev, nxt = self.window(d), self.window(n)
        return dict(prev_vmin=prev[2], prev_vmax=prev[3], next_vmin=nxt[2], next_vmax=nxt[3],
                    inj=self.inj_curve(d), wd=self.wd_curve(d),
                    inj_cost=self._cost(self.inj_cost, d), wd_cost=self._cost(self.wd_cost, d),
                    period=max(n - d, 0.0), last=n >= self.end - DATE_TOL)


def interp(x: torch.Tensor, curve) -> torch.Tensor:
    """A flexibility curve at volumes x: linear inside, flat outside."""
    xs = torch.tensor([c[0] for c in curve], dtype=F64, device=x.device)
    ys = torch.tensor([c[1] for c in curve], dtype=F64, device=x.device)
    if len(curve) == 1:
        return ys[0].expand(x.shape)
    i = torch.clamp(torch.searchsorted(xs, x.contiguous(), right=True), 1, len(curve) - 1)
    x0, x1, y0, y1 = xs[i - 1], xs[i], ys[i - 1], ys[i]
    f = y0 + ((x - x0) / (x1 - x0)) * (y1 - y0)
    return torch.where(x < xs[0], ys[0], torch.where(x > xs[-1], ys[-1], f))


def lookup(values: torch.Tensor, state: torch.Tensor, s_count: int) -> torch.Tensor:
    """values [N, S] at continuous states [N, K], linear between grid states."""
    b = torch.clamp(state, 0.0, s_count - 1.0)
    lo, hi = torch.floor(b).long(), torch.ceil(b).long()
    v_lo, v_hi = values.gather(1, lo), values.gather(1, hi)
    return v_lo + (b - lo.to(F64)) * (v_hi - v_lo)


def storage_step(c, s_count, state, spot, num, grid):
    """(next states, deflated cashflows) of one date from states [N, K]."""
    spot = spot[:, None].expand(state.shape)
    prev_vol = c["prev_vmin"] + state * (c["prev_vmax"] - c["prev_vmin"]) / (s_count - 1.0)
    next_span = max(c["next_vmax"] - c["next_vmin"], 1e-30)
    inject = torch.clamp(prev_vol + interp(prev_vol, c["inj"]) * c["period"], max=c["next_vmax"])
    withdraw = torch.clamp(prev_vol - interp(prev_vol, c["wd"]) * c["period"], min=c["next_vmin"])
    hold = torch.clamp(torch.clamp(prev_vol, min=c["next_vmin"]), max=c["next_vmax"])
    buy, sell = spot + c["inj_cost"], spot - c["wd_cost"]
    best_value = best_state = best_cash = None
    for vol, price in ((inject, buy), (hold, None), (withdraw, sell)):
        nxt = (vol - c["next_vmin"]) * (s_count - 1.0) / next_span
        delta = vol - prev_vol
        cash = -delta * (torch.where(delta >= 0.0, buy, sell) if price is None else price)
        cont = 0.0 if c["last"] else lookup(grid, nxt, s_count)
        value = cash + cont
        if best_value is None:
            best_value, best_state, best_cash = value, nxt, cash
        else:  # a later action wins only if strictly better
            better = value > best_value
            best_value = torch.where(better, value, best_value)
            best_state = torch.where(better, nxt, best_state)
            best_cash = torch.where(better, cash, best_cash)
    return best_state, best_cash / num[:, None]


def storage_lsm(p, pre: Phase, main: Phase) -> torch.Tensor:
    """Deflated cashflows [N] of a storage deal on the main paths, its
    policy fitted on the pre-simulation over every grid state."""
    terms = StorageTerms(p)
    s_count, asset, dev = int(p["num_states"]), p["asset_id"], pre.states.device
    consts = [terms.at(e) for e in range(len(terms.dates))]
    n_pre = pre.states.shape[1]
    grid_states = torch.arange(s_count, dtype=F64, device=dev).expand(n_pre, -1)
    carry = torch.zeros((n_pre, s_count), dtype=F64, device=dev)
    coeffs = [None] * len(consts)
    for e in reversed(range(len(consts))):
        x, num = pre.spot(terms.dates[e], asset), pre.numeraire(terms.dates[e])
        coeffs[e] = fit(x, num[:, None] * carry)
        nxt, cash = storage_step(consts[e], s_count, grid_states, x, num,
                                 continuation(x, coeffs[e]))
        carry = cash + lookup(carry, nxt, s_count)
    n_main = main.states.shape[1]
    state = torch.zeros((n_main, 1), dtype=F64, device=dev)  # the initial volume's state
    total = torch.zeros(n_main, dtype=F64, device=dev)
    for e in range(len(consts)):
        x, num = main.spot(terms.dates[e], asset), main.numeraire(terms.dates[e])
        state, cash = storage_step(consts[e], s_count, state, x, num, continuation(x, coeffs[e]))
        total = total + cash[:, 0]
    return total


# -- the book ----------------------------------------------------------------------------------


def family_pvs(cfg, traffic, seed: int, device) -> Dict[str, float]:
    """{product type: its products' PV} of one run's seed."""
    assets, _, _, rate, _ = model_parts(cfg)
    times = timeline(cfg)
    n_main, n_pre = int(traffic["num_paths"]), int(traffic["num_paths_presim"])
    seed &= 0xFFFFFFFF
    main = Phase(paths(seed, philox.PHASE_MAINSIM, n_main, cfg, times, device), times, assets,
                 rate)
    pre = None
    out: Dict[str, float] = {}
    for p, count in distinct_products(cfg):
        kind = p["type"]
        if kind in EXERCISE:
            if pre is None:
                pre = Phase(paths(seed, philox.PHASE_PRESIM, n_pre, cfg, times, device), times,
                            assets, rate)
            cash = (storage_lsm if kind == "Storage" else option_lsm)(p, pre, main)
        else:
            cash = terminal_cashflows(p, main)
        out[kind] = out.get(kind, 0.0) + count * float(cash.sum()) / n_main
    return out


def reference_pv(cfg, traffic, seed: int, device) -> float:
    """The book's PV, float64, TF32 off for the regressions' products."""
    keep = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return sum(family_pvs(cfg, traffic, seed, device).values())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def check(cfg, traffic, runs, device) -> Dict[str, float]:
    """The compared number of the sampled runs against the reference."""
    gap = 0.0
    for run in runs:
        (pv,) = run.values
        ref = reference_pv(cfg, traffic, run.seed, device)
        gap = max(gap, abs(pv - ref) / abs(ref))
    return {"pv_gap": gap}
