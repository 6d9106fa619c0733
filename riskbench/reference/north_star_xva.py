"""Plain reference of the north-star xVA book: CVA, EPE and PFE, and their
first-order greeks.

The book: one netting set with a margin period of risk, swaps on a Vasicek
short rate and European options on a Black-Scholes equity, a CIR++ default
intensity for the counterparty, the three shocks correlated; Euler steps
on the union of the product dates, the exposure dates and the dates one
margin period before them.

Paths.  Each substep's three correlated shocks are w = L z, z the
substep's Philox normals (pre-simulation phase 42, main phase 43), L the
Cholesky factor of the shock correlation.  Per substep of length dt:
  r'  = r + a (m - r) dt + s_r sqrt(dt) w_r,      log B += r dt
  S'  = S (1 + q dt) + s_S S sqrt(dt) w_S          (q: the equity model's rate)
  y'  = max(y + k (th - y) dt + s_y sqrt(max(y, 0)) sqrt(dt) w_y, 1e-12),
  log C += (y + psi(t1)) dt,
  psi(t) = lambda_mkt(t) + D(t) - y0 E(t) (the CIR++ shift that fits the
  market hazard curve).
On the path kernel's route (first-order greeks) the states are float32: the
reference repeats that arithmetic op for op (psi and the other table
values rounded once from float64) and then, as a pathwise derivative needs,
recovers each step's shocks from consecutive float32 states in float64 (a
step that landed on the 1e-12 floor of y keeps it, with derivative 0) and
rebuilds the float64 path through them with the parameters live.  On the
engine's route (forward) the normals and the states are float64.

Valuation, float64.  Numeraire N = exp(log B).  Discounted cashflows: a
fixed coupon c dt / N(pay), a floating one dt L(t1, t2) / N(pay) with the
Vasicek LIBOR (1 / P(t1, t2 | r) - 1) / (t2 - t1) on the state at the pay
date, a European's payoff / N(T).  Exposures on the exposure dates by
least squares on the pre-simulation (degree-2 monomials of the asset's own
state, r or S, rescaled by their RMS, a ridge of 1e-10 of the mean Gram
diagonal): each product's future discounted cashflows times N(t) regressed
on the basis; the netting set's exposure is the sum of the fitted values
over N(t).  Unsecured exposure U(t) = E(t) - E(t - MPoR) (nothing before
the first margin call).  EPE(t) = mean max(U, 0); PFE(t) = the
ceil(0.95 N)-th smallest U; CVA = (1 - R) mean sum_k max(U_k, 0) S_k (1 -
S(t_k, t_k+1 | y_k)), S_k = exp(-log C(t_k)), the conditional survival the
CIR++ closed form.  Greeks: forward-mode derivatives by the 11 parameters.

Compared numbers (each the worst over the sampled runs): ``value_gap``,
the worst of the 59 values' |v - v_ref| over max(|v_ref|, the median
|v_ref| of its metric); ``jac_gap``, the worst parameter column's gap in
the same measure against the median |d v_ref / d theta| of its metric.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict, List

import numpy as np
import torch

from riskbench import book, counting
from riskbench.reference import philox

F32, F64 = torch.float32, torch.float64
FLOOR = 1e-12
RIDGE = 1e-10
ENGINE_BLOCK_PATHS = 1 << 21


class Book:
    """The configuration's numbers, read once."""

    def __init__(self, cfg):
        vas, eq, cp = cfg["model"]["models"]
        self.r0, self.s_r = vas["rate"], vas["volatility"]
        self.m, self.a = vas["mean"], vas["mean_reversion_speed"]
        self.S0, self.q, self.s_S = eq["spot"], eq["rate"], eq["sigma"]
        self.k, self.th, self.s_y, self.y0 = cp["kappa"], cp["theta"], cp["volatility"], cp["y0"]
        self.tenors = [float(t) for t in cp["hazard_rates"]]
        self.hazards = [float(h) for h in cp["hazard_rates"].values()]
        c = cfg["model"]["inter_asset_correlation_matrix"]
        self.corr = np.array([[1.0, c[0][0][0], c[1][0][0]], [c[0][0][0], 1.0, c[2][0][0]],
                              [c[1][0][0], c[2][0][0], 1.0]])
        self.theta0 = [self.r0, self.s_r, self.m, self.a, self.S0, self.s_S, self.q,
                       self.k, self.th, self.s_y, self.y0]
        (ns,) = cfg["netting_sets"]
        self.mpor = float(ns["margin_period_of_risk"])
        (cva, _, pfe) = cfg["metrics"]["metrics"]
        self.recovery, self.quantile = float(cva["recovery_rate"]), float(pfe["quantile"])
        self.metric_dates = [float(t) for t in book.exposure_timeline(cfg)]
        grid = set(self.metric_dates) | {t - self.mpor for t in self.metric_dates
                                          if t - self.mpor >= 0.0}
        self.grid = sorted(grid)
        (products,) = book.netting_set_products(cfg)
        self.swaps = [p for p in products if p["type"] == "InterestRateSwap"]
        self.options = [p for p in products if p["type"] == "EuropeanOption"]
        dates = set(self.grid) | {float(p["exercise_date"]) for p in self.options}
        for s in self.swaps:
            dates |= {e[1] for e in swap_events(s)}
        self.timeline = sorted(dates)
        self.index = {t: i for i, t in enumerate(self.timeline)}
        self.steps = int(cfg["num_steps"])
        if self.steps != 1:
            raise ValueError("the north-star reference takes one substep a date")

    # the market hazard: the first tenor >= t, flat beyond the last
    def lambda_mkt(self, t: float) -> float:
        return self.hazards[min(bisect_left(self.tenors, t), len(self.tenors) - 1)]

    def lambda_mkt_f32(self, t: float) -> float:
        t32 = np.float32(t)
        for tenor, rate in zip(self.tenors, self.hazards):
            if t32 <= np.float32(tenor):
                return rate
        return self.hazards[-1]


def swap_events(s):
    """(kind, pay date, amount, (t1, t2)) of one swap's coupons: fixed
    amounts are sign c dt, floating ones sign dt times the LIBOR of (t1, t2);
    the payer pays fixed."""
    start, end, tenor_f, tenor_l = (float(s["startdate"]), float(s["enddate"]),
                                    float(s["tenor_fixed"]), float(s["tenor_float"]))
    fixed_sign = -1.0 if s["irs_type"]["value"] == "PAYER" else 1.0
    out = []
    for tenor, fixed in ((tenor_f, True), (tenor_l, False)):
        dates, date = [], start + tenor
        while date < end - 1e-12:
            dates.append(date)
            date += tenor
        last_t1 = date - tenor
        dates.append(end)
        prev = start
        for i, pay in enumerate(dates):
            dt = pay - prev
            prev = pay
            if fixed:
                out.append(("fixed", pay, fixed_sign * float(s["notional"]) * float(s["fixed_rate"]) * dt,
                            None))
            else:
                t1, t2 = (pay - tenor, pay) if i < len(dates) - 1 else (last_t1, end)
                out.append(("float", pay, -fixed_sign * float(s["notional"]) * dt, (t1, t2)))
    return out


def path_launches(cfg, traffic) -> List[counting.Launch]:
    """The path kernel's launches in one run: the pre-simulation and the main
    simulation on the kernel's route; none on the engine's."""
    if not traffic["differentiate"]:
        return []
    b = Book(cfg)
    blocks = (counting.Block("vasicek", "euler"), counting.Block("bs", "euler"),
              counting.Block("cirpp", "euler"))
    chol = np.linalg.cholesky(b.corr)
    return [counting.Launch(blocks, chol, tuple(b.timeline), 1, int(traffic[k]))
            for k in ("num_paths_presim", "num_paths")]


# -- CIR++ closed forms ------------------------------------------------------------


def _cir_h(k, s):
    return torch.sqrt(k * k + 2.0 * s * s)


def psi(b: Book, th, t: float):
    """lambda_mkt(t) + D(t) - y0 E(t) for parameters th = (k, theta, s, y0)."""
    k, theta, s, y0 = th
    h = _cir_h(k, s)
    et = torch.exp(h * t)
    den = 2.0 * h + (k + h) * (et - 1.0)
    d = (2.0 * k * theta / (s * s)) * (0.5 * (k + h) - h * (k + h) * et / den)
    e = 4.0 * h * h * et / (den * den)
    return b.lambda_mkt(t) + d - y0 * e


def _cir_a(th, dt):
    k, theta, s, _ = th
    h = _cir_h(k, s)
    num = 2.0 * h * torch.exp(0.5 * (k + h) * dt)
    den = 2.0 * h + (k + h) * (torch.exp(h * dt) - 1.0)
    return (num / den) ** (2.0 * k * theta / (s * s))


def _cir_b(th, dt):
    k, _, s, _ = th
    h = _cir_h(k, s)
    e = torch.exp(h * dt) - 1.0
    return 2.0 * e / (2.0 * h + (k + h) * e)


def market_survival(b: Book, t: float) -> float:
    integral, prev = 0.0, 0.0
    for tenor, hz in zip(b.tenors, b.hazards):
        integral += hz * max(min(tenor, t) - prev, 0.0)
        prev = tenor
    integral += b.hazards[-1] * max(t - b.tenors[-1], 0.0)
    return math.exp(-integral)


def conditional_survival(b: Book, th, t: float, T: float, y):
    y0 = th[3]
    pref = (market_survival(b, T) / market_survival(b, t)) * (_cir_a(th, t) / _cir_a(th, T)) \
        * torch.exp(-_cir_b(th, t) * y0 + _cir_b(th, T) * y0)
    return pref * _cir_a(th, T - t) * torch.exp(-_cir_b(th, T - t) * y)


def vasicek_libor(th_r, t1: float, t2: float, r):
    _, s, m, a = th_r
    dt = t2 - t1
    bb = (1.0 - torch.exp(-a * dt)) / a
    alpha = (m - s * s / (2.0 * a * a)) * (bb - dt) - (s * s / (4.0 * a)) * bb * bb
    p = torch.exp(alpha) * torch.exp(-bb * r)
    return (1.0 / p - 1.0) / dt


# -- paths ---------------------------------------------------------------------------


def kernel_states(b: Book, seed: int, phase: int, n: int, device) -> List[torch.Tensor]:
    """[T] x [n, 5] float32 states (r, log B, S, y, log C) of the kernel's
    route, every operation in the kernel's order."""
    paths = torch.arange(n, dtype=torch.int64, device=device)
    t32 = lambda v: torch.tensor(v, dtype=F64, device=device).to(F32)
    s_r, m, a, s_S, q, k, th, s_y = (t32(v) for v in (b.s_r, b.m, b.a, b.s_S, b.q, b.k, b.th, b.s_y))
    chol = np.linalg.cholesky(b.corr).astype(np.float32)
    th64 = [torch.tensor(v, dtype=F64, device=device) for v in (b.k, b.th, b.s_y, b.y0)]
    r = t32(b.r0).expand(n)
    lb = t32(0.0).expand(n)
    S = t32(b.S0).expand(n)
    y = t32(b.y0).expand(n)
    lc = t32(0.0).expand(n)
    out, t_prev = [], 0.0
    for i, t in enumerate(b.timeline):
        if t > t_prev:
            dt = t - t_prev
            dt32, sq32 = t32(dt), t32(np.sqrt(dt))
            lam_f = torch.tensor(b.lambda_mkt_f32(t_prev), dtype=F64, device=device)
            psi32 = (psi_table(th64, t_prev, lam_f)).to(F32)
            z = philox.normals(seed, phase, i, paths, 3, F32)
            w = []
            for j in range(3):
                acc = float(chol[j, 0]) * z[:, 0]
                for e in range(1, j + 1):
                    acc = acc + float(chol[j, e]) * z[:, e]
                w.append(acc)
            rr = r
            lb = lb + rr * dt32
            r = rr + a * (m - rr) * dt32 + s_r * sq32 * w[0]
            S = S * (1.0 + q * dt32) + s_S * S * sq32 * w[1]
            yy = y
            lc = lc + (yy + psi32) * dt32
            sqrt_y = torch.sqrt(torch.clamp(yy, min=0.0))
            y = torch.clamp(yy + k * (th - yy) * dt32 + s_y * sqrt_y * sq32 * w[2], min=FLOOR)
            t_prev = t
        out.append(torch.stack([r.expand(n), lb.expand(n), S.expand(n), y.expand(n),
                                lc.expand(n)], dim=-1))
    return out


def psi_table(th64, t1: float, lam):
    """psi(t1) as the kernel's table computes it (float64, the market hazard
    looked up with float32 times)."""
    k, theta, s, y0 = th64
    h = torch.sqrt(k * k + 2.0 * s * s)
    et = torch.exp(h * t1)
    den = 2.0 * h + (k + h) * (et - 1.0)
    d_term = (2.0 * k * theta / (s * s)) * (0.5 * (k + h) - h * (k + h) * et / den)
    e_term = 4.0 * h * h * et / (den * den)
    return lam + d_term - y0 * e_term


def recovered_shocks(b: Book, states: List[torch.Tensor]) -> List[torch.Tensor]:
    """Per date, the float64 shocks [n, 3] that carry each step from the
    previous float32 state to the next (zeros at a date that does not move)."""
    th = b.theta0
    out, prev, t_prev = [], None, 0.0
    for t, st in zip(b.timeline, states):
        x = st.to(F64)
        if prev is None or t <= t_prev:
            out.append(torch.zeros((x.shape[0], 3), dtype=F64, device=x.device))
        else:
            dt = t - t_prev
            sq = math.sqrt(dt)
            r, S, y = prev[:, 0], prev[:, 2], prev[:, 3]
            w_r = (x[:, 0] - r - th[3] * (th[2] - r) * dt) / (th[1] * sq)
            w_s = (x[:, 2] / S - 1.0 - th[6] * dt) / (th[5] * sq)
            diff = th[9] * torch.sqrt(torch.clamp(y, min=0.0)) * sq
            drift = th[7] * (th[8] - y) * dt
            target = torch.where(x[:, 3] <= FLOOR, -(y.abs() + drift.abs()), x[:, 3])
            live = diff > 0.0
            w_y = torch.where(live, (target - y - drift) / torch.where(live, diff, 1.0), 0.0)
            out.append(torch.stack([w_r, w_s, w_y], dim=-1))
        prev, t_prev = x, t
    return out


def rebuilt_states(b: Book, theta, shocks: List[torch.Tensor]):
    """The float64 path through the recovered shocks with live parameters:
    per date (r, log B, S, y, log C), each [n]."""
    r0, s_r, m, a, S0, s_S, q, k, th, s_y, y0 = theta
    n = shocks[0].shape[0]
    r, lb, S, y, lc = r0.expand(n), 0.0 * r0.expand(n), S0.expand(n), y0.expand(n), 0.0 * y0.expand(n)
    out, t_prev = [], 0.0
    for t, w in zip(b.timeline, shocks):
        if t > t_prev:
            dt = t - t_prev
            sq = math.sqrt(dt)
            lb = lb + r * dt
            r = r + a * (m - r) * dt + s_r * sq * w[:, 0]
            S = S + q * S * dt + s_S * S * sq * w[:, 1]
            lc = lc + (y + psi(b, (k, th, s_y, y0), t_prev)) * dt
            y = torch.clamp(y + k * (th - y) * dt + s_y * torch.sqrt(torch.clamp(y, min=0.0)) * sq
                            * w[:, 2], min=FLOOR)
            t_prev = t
        out.append((r, lb, S, y, lc))
    return out


def engine_states(b: Book, seed: int, phase: int, paths: torch.Tensor):
    """The engine's float64 path for the given global paths: per date (r,
    log B, S, y, log C), each [n]."""
    dev = paths.device
    theta = [torch.tensor(v, dtype=F64, device=dev) for v in b.theta0]
    chol = torch.linalg.cholesky(torch.tensor(b.corr, dtype=F64, device=dev))
    shocks, t_prev = [], 0.0
    for i, t in enumerate(b.timeline):
        if t > t_prev:
            shocks.append(philox.normals(seed, phase, i, paths, 3, F64) @ chol.T)
            t_prev = t
        else:
            shocks.append(torch.zeros((len(paths), 3), dtype=F64, device=dev))
    return rebuilt_states(b, theta, shocks)


# -- valuation -------------------------------------------------------------------------


def _obs(b: Book, states, t):
    return states[b.index[t]]


def cashflows_future(b: Book, theta, states):
    """{asset: per product, per exposure date the product's discounted
    cashflows paid after that date [n], or None}."""
    th_r = theta[0:4]
    out = {"irs": [], "eq": []}
    for s in b.swaps:
        paid = []  # (pay date, discounted cashflow [n]) of every coupon
        for kind, pay, amount, fix in swap_events(s):
            r, lb = _obs(b, states, pay)[0], _obs(b, states, pay)[1]
            cf = amount / torch.exp(lb) if kind == "fixed" else \
                amount * vasicek_libor(th_r, fix[0], fix[1], r) / torch.exp(lb)
            paid.append((pay, cf))
        rows, acc = [], None
        for t in reversed(b.grid):  # running sum of the coupons paid after t
            for pay, cf in paid:
                if t < pay and (not rows or pay <= rows[-1][0]):
                    acc = cf if acc is None else acc + cf
            rows.append((t, acc))
        out["irs"].append([acc for _, acc in reversed(rows)])
    for o in b.options:
        T, K = float(o["exercise_date"]), float(o["strike"])
        _, lb, S, _, _ = _obs(b, states, T)
        sign = 1.0 if o["option_type"]["value"] == "CALL" else -1.0
        cf = torch.clamp(sign * (S - K), min=0.0) / torch.exp(lb)
        out["eq"].append([cf if T > t else None for t in b.grid])
    return out


def explanatory(b: Book, states, asset: str, t: float):
    st = _obs(b, states, t)
    return st[0] if asset == "irs" else st[2]


def fit(b: Book, theta, states):
    """{asset: [exposure date] -> coefficients [3] of the netting set's
    fitted value (the products' coefficients summed)}."""
    flows = cashflows_future(b, theta, states)
    coeffs = {}
    for asset, per_product in flows.items():
        rows = []
        for j, t in enumerate(b.grid):
            x = explanatory(b, states, asset, t)
            num = torch.exp(_obs(b, states, t)[1])
            n = x.shape[0]
            s1 = torch.sqrt((x * x).sum() / n)
            yv = x / s1
            p = [torch.full((), float(n), dtype=F64, device=x.device)] + \
                [(yv ** e).sum() for e in range(1, 5)]
            gram = torch.stack([torch.stack([p[d + e] for e in range(3)]) for d in range(3)])
            gram = gram + (RIDGE * (p[0] + p[2] + p[4]) / 3.0 + 1e-30) * torch.eye(
                3, dtype=F64, device=x.device)
            total = None
            for cfs in per_product:
                if cfs[j] is None:
                    continue
                rhs = torch.stack([(num * yv ** d * cfs[j]).sum() for d in range(3)])
                sol = torch.linalg.solve(gram, rhs) / s1 ** torch.arange(3, device=x.device)
                total = sol if total is None else total + sol
            rows.append(total)
        coeffs[asset] = rows
    return coeffs


def exposures(b: Book, coeffs, states):
    """Per exposure date the netting set's discounted exposure [n]."""
    out = []
    for j, t in enumerate(b.grid):
        num = torch.exp(_obs(b, states, t)[1])
        e = 0.0
        for asset, rows in coeffs.items():
            c = rows[j]
            if c is None:
                continue
            x = explanatory(b, states, asset, t)
            e = e + (c[0] + x * (c[1] + x * c[2])) / num
        out.append(e if torch.is_tensor(e) else torch.zeros_like(num))
    return out


def metrics(b: Book, theta, states, coeffs):
    """(CVA sum over paths, EPE sums [29], unsecured exposures [29] x [n])."""
    ex = exposures(b, coeffs, states)
    grid_idx = {t: i for i, t in enumerate(b.grid)}
    unsecured = []
    for t in b.metric_dates:
        e = ex[grid_idx[t]]
        if t - b.mpor >= 0.0:
            e = e - ex[grid_idx[t - b.mpor]]
        unsecured.append(e)
    th_c = theta[7:11]
    cva = 0.0
    for kk in range(len(b.metric_dates) - 1):
        t, t_next = b.metric_dates[kk], b.metric_dates[kk + 1]
        st = _obs(b, states, t)
        sp = torch.exp(-st[4])
        csp = conditional_survival(b, th_c, t, t_next, st[3])
        cva = cva + torch.clamp(unsecured[kk], min=0.0) * sp * (1.0 - csp)
    epe = torch.stack([torch.clamp(u, min=0.0).sum() for u in unsecured])
    return (1.0 - b.recovery) * cva.sum(), epe, unsecured


def values_of(b: Book, theta, pre, main):
    """The 59 values (CVA, EPE x 29, PFE x 29) from the pre-simulation and
    main paths (lists of per-date tuples)."""
    coeffs = fit(b, theta, pre)
    cva, epe, unsecured = metrics(b, theta, main, coeffs)
    n = unsecured[0].shape[0]
    q = int(math.ceil(b.quantile * n)) - 1
    pfe = torch.stack([torch.sort(u).values[q] for u in unsecured])
    return torch.cat([(cva / n).reshape(1), epe / n, pfe])


def reference_kernel_route(b: Book, traffic, seed: int, device):
    """(values [59], jacobian [59, 11]) of one run on the path kernel's route."""
    seed &= 0xFFFFFFFF
    shocks = {}
    for phase, key in ((philox.PHASE_PRESIM, "num_paths_presim"), (philox.PHASE_MAINSIM, "num_paths")):
        states = kernel_states(b, seed, phase, int(traffic[key]), device)
        shocks[phase] = recovered_shocks(b, states)
        del states
    theta0 = torch.tensor(b.theta0, dtype=F64, device=device)

    def f(theta):
        th = list(theta.unbind(0))
        return values_of(b, th, rebuilt_states(b, th, shocks[philox.PHASE_PRESIM]),
                         rebuilt_states(b, th, shocks[philox.PHASE_MAINSIM]))

    import torch.autograd.forward_ad as fwad
    jac = []
    values = None
    for i in range(len(b.theta0)):
        tangent = torch.zeros_like(theta0)
        tangent[i] = 1.0
        with fwad.dual_level():
            out = f(fwad.make_dual(theta0, tangent))
            primal, tan = fwad.unpack_dual(out)
        values = primal if values is None else values
        jac.append(tan)
    return values.cpu().numpy(), torch.stack(jac, dim=1).cpu().numpy()


def reference_engine_route(b: Book, traffic, seed: int, device):
    """values [59] of one forward run on the engine's route, the main
    simulation in blocks of paths."""
    seed &= 0xFFFFFFFF
    theta = [torch.tensor(v, dtype=F64, device=device) for v in b.theta0]
    n_pre, n = int(traffic["num_paths_presim"]), int(traffic["num_paths"])
    pre = engine_states(b, seed, philox.PHASE_PRESIM,
                        torch.arange(n_pre, dtype=torch.int64, device=device))
    coeffs = fit(b, theta, pre)
    del pre
    cva, epe, parts = 0.0, 0.0, []
    for lo in range(0, n, ENGINE_BLOCK_PATHS):
        paths = torch.arange(lo, min(n, lo + ENGINE_BLOCK_PATHS), dtype=torch.int64, device=device)
        main = engine_states(b, seed, philox.PHASE_MAINSIM, paths)
        c, e, u = metrics(b, theta, main, coeffs)
        cva, epe = cva + c, epe + e
        parts.append(torch.stack(u))
        del main
    unsecured = torch.cat(parts, dim=1)
    q = int(math.ceil(b.quantile * n)) - 1
    pfe = torch.kthvalue(unsecured, q + 1, dim=1).values
    return torch.cat([(cva / n).reshape(1), epe / n, pfe]).cpu().numpy(), None


def _gap(got, ref, metric_of):
    """Worst |got - ref| over max(|ref|, the median |ref| of its metric)."""
    worst = 0.0
    for m in set(metric_of):
        rows = [i for i, x in enumerate(metric_of) if x == m]
        scale = np.maximum(np.abs(ref[rows]), np.median(np.abs(ref[rows]), axis=0))
        scale = np.where(scale > 0, scale, 1.0)
        worst = max(worst, float(np.max(np.abs(got[rows] - ref[rows]) / scale)))
    return worst


def check(cfg, traffic, runs, device) -> Dict[str, float]:
    b = Book(cfg)
    names = ["rate", "volatility", "mean", "mean_reversion_speed", "spot", "volatility", "rate",
             "kappa", "theta", "sigma", "y0"]
    labels = [f"{a}.{p}" for a, p in zip(["irs"] * 4 + ["eq"] * 3 + ["counterparty"] * 4, names)]
    value_gap, jac_gap = 0.0, 0.0
    for run in runs:
        metric_of = [nm.split("/")[1] for nm in run.names]
        if traffic["differentiate"]:
            ref, ref_jac = reference_kernel_route(b, traffic, run.seed, device)
            jac = np.stack([run.jac[:, run.param_names.index(p)] for p in labels], axis=1)
            jac_gap = max(jac_gap, _gap(jac, ref_jac, metric_of))
        else:
            ref, _ = reference_engine_route(b, traffic, run.seed, device)
        value_gap = max(value_gap, _gap(run.values, ref, metric_of))
    out = {"value_gap": value_gap}
    if traffic["differentiate"]:
        out["jac_gap"] = jac_gap
    return out
