"""Plain reference of the BS-multi European book: PV and its jacobian.

The book: European calls and puts on the assets of one multi-asset
Black-Scholes model with a constant rate, valued together as one netting
set's PV, the mean over paths of the deflated payoffs.

Paths: the configuration states float32 paths (exact scheme, the state is
log S).  Per substep of length dt the correlated shock is w = L z, with z
the substep's Philox normals and L the Cholesky factor of the asset
correlation, both in float32, the products summed left to right; then
log S += (r - s^2 / 2) dt + s sqrt(dt) w and S = exp(log S) at each date,
every operation rounded to float32 in this order (dt and sqrt(dt) rounded
once from float64, log S0 likewise).  The valuation is float64: PV =
sum over options of e^{-rT} mean(payoff(S_T)).  The jacobian is the
pathwise derivative by the spots, the volatilities and the rate of the
float64 path log S_T = log S0 + sum((r - s^2 / 2) dt + s sqrt(dt) v) that
passes through the float32 states: its shocks v are recovered in float64
from consecutive states, v = (log S_k - log S_{k-1} - (r - s^2 / 2) dt) /
(s sqrt(dt)) with S_{-1} = S0, and held fixed.

Compared numbers (each the worst over the sampled runs):
  * ``pv_gap``: |PV - PV_ref| / |PV_ref|;
  * ``jac_gap``: the worst parameter's |g - g_ref| over the larger of
    |g_ref| and the median |g_ref| over the parameters.  Where a float32
    state equals a strike the payoff has a kink, and which side of it the
    derivative takes is decided by a float64 rebuild of the state, whose
    rounding falls either way.  The port's differentiated route rebuilds
    the state from the float32 states by recovering each date's shocks
    against the Cholesky factor of the one-step covariance and stepping
    S <- S exp(drift + L z) again; the reference repeats that rebuild, op
    for op on the same device over all paths at once, and reads it at the
    tied states to decide their side (at or above the strike: the calls
    there count); the tied pairs' derivatives come from its own path.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from riskbench import book, counting
from riskbench.reference import philox

BLOCK_PATHS = 1 << 18
F32, F64 = torch.float32, torch.float64


def model_parts(cfg):
    m = cfg["model"]
    corr = np.asarray(m["correlation_matrix"], dtype=np.float64)
    return (list(m["asset_ids"]), [float(s) for s in m["spots"]],
            [float(v) for v in m["volatilities"]], float(m["rate"]), corr)


def option_groups(cfg):
    """Distinct options as (asset index, maturity, strike, is call) and how
    many times each appears in the book."""
    assets = model_parts(cfg)[0]
    rows = [(assets.index(p["asset_id"]), float(p["exercise_date"]), float(p["strike"]),
             p["option_type"]["value"] == "CALL")
            for ns in book.netting_set_products(cfg) for p in ns]
    groups: Dict[tuple, int] = {}
    for r in rows:
        groups[r] = groups.get(r, 0) + 1
    return groups


def timeline(cfg) -> List[float]:
    return sorted({g[1] for g in option_groups(cfg)})


def path_launches(cfg, traffic) -> List[counting.Launch]:
    """The path launches of one run: the main simulation alone (a PV of
    Europeans needs no pre-simulation)."""
    assets, _, _, _, corr = model_parts(cfg)
    blocks = (counting.Block("bs_multi", "exact" if cfg["scheme"] == "ANALYTICAL" else "euler",
                             len(assets)),)
    return [counting.Launch(blocks, np.linalg.cholesky(corr), tuple(timeline(cfg)),
                            int(cfg["num_steps"]), int(traffic["num_paths"]))]


def _steps(times: Sequence[float], num_steps: int):
    """Per point, its substeps' (counter, dt) (none for a zero-length point)."""
    out, t_prev = [], 0.0
    for i, t in enumerate(times):
        dt = (t - t_prev) / num_steps
        out.append([(i * num_steps + k, dt) for k in range(num_steps)] if t > t_prev else [])
        t_prev = t
    return out


def paths_block(seed: int, paths: torch.Tensor, spots, vols, rate, chol32: np.ndarray,
                times, num_steps: int):
    """S at each date, [T] x [n, A] float32, for the given global paths."""
    dev = paths.device
    n_a = len(spots)
    sig = [torch.tensor(v, dtype=F64, device=dev).to(F32) for v in vols]
    r32 = torch.tensor(rate, dtype=F64, device=dev).to(F32)
    log_s = [torch.log(torch.tensor(s, dtype=F64, device=dev)).to(F32).expand(len(paths))
             for s in spots]
    states = []
    for steps in _steps(times, num_steps):
        for counter, dt in steps:
            z = philox.normals(seed, philox.PHASE_MAINSIM, counter, paths, n_a, F32)
            dt32 = torch.tensor(dt, dtype=F64, device=dev).to(F32)
            sq32 = torch.tensor(np.sqrt(dt), dtype=F64, device=dev).to(F32)
            w = []
            for i in range(n_a):
                acc = float(chol32[i, 0]) * z[:, 0]
                for e in range(1, i + 1):
                    acc = acc + float(chol32[i, e]) * z[:, e]
                w.append(acc)
            for i in range(n_a):
                log_s[i] = log_s[i] + (r32 - 0.5 * sig[i] * sig[i]) * dt32 + sig[i] * sq32 * w[i]
        states.append(torch.stack([torch.exp(x) for x in log_s], dim=-1))
    return states


def _payoff_sum(groups, times, s_at, df_at, ties=None):
    """Sum over option groups of count * df(T) * sum over paths of payoff,
    without the tied paths of ``ties`` {(date index, asset, strike): mask}."""
    total = 0.0
    for (a, t, k, call), count in groups.items():
        i = times.index(t)
        s = s_at(i)[:, a]
        pay = torch.clamp(s - k, min=0.0) if call else torch.clamp(k - s, min=0.0)
        if ties is not None and (i, a, k) in ties:
            pay = torch.where(ties[i, a, k], torch.zeros_like(pay), pay)
        total = total + count * df_at(t) * pay.sum()
    return total


def reference_run(cfg, traffic, seed: int, device, differentiate: bool):
    """(PV, jacobian [P]) of one run's seed, float64 on ``device``; without
    greeks the jacobian is None."""
    assets, spots, vols, rate, corr = model_parts(cfg)
    chol32 = np.linalg.cholesky(corr).astype(np.float32)
    times = timeline(cfg)
    groups = option_groups(cfg)
    n, steps = int(traffic["num_paths"]), int(cfg["num_steps"])
    if differentiate and steps != 1:
        raise ValueError("the jacobian's shocks are recovered from one substep a date")
    theta = torch.tensor(spots + vols + [rate], dtype=F64, device=device,
                         requires_grad=differentiate)
    n_a = len(assets)
    pv = 0.0
    grad = torch.zeros(len(theta), dtype=F64, device=device)
    ties, blocks = [], []
    for start in range(0, n, BLOCK_PATHS):
        paths = torch.arange(start, min(n, start + BLOCK_PATHS), dtype=torch.int64, device=device)
        states = paths_block(seed & 0xFFFFFFFF, paths, spots, vols, rate, chol32, times, steps)
        with torch.no_grad():
            pv += float(_payoff_sum(groups, times, lambda i: states[i].to(F64),
                                    lambda t: np.exp(-rate * t)))
        if differentiate:
            s0, sig, r = theta[:n_a], theta[n_a:2 * n_a], theta[2 * n_a]
            vol0 = torch.tensor(vols, dtype=F64, device=device)
            prev = torch.log(torch.tensor(spots, dtype=F64, device=device)).expand(len(paths), n_a)
            log_s, by_point, t_prev = torch.log(s0).expand(len(paths), n_a), [], 0.0
            wsum, sums = torch.zeros_like(prev), []
            for t, state in zip(times, states):
                if t > t_prev:  # one substep a date (num_steps = 1)
                    dt = t - t_prev
                    now = torch.log(state.to(F64))
                    v = (now - prev - (rate - 0.5 * vol0 * vol0) * dt) / (vol0 * np.sqrt(dt))
                    log_s = log_s + (r - 0.5 * sig * sig) * dt + sig * np.sqrt(dt) * v
                    wsum = wsum + np.sqrt(dt) * v
                    prev, t_prev = now, t
                by_point.append(torch.exp(log_s))
                sums.append(wsum)
            masks = {}
            for (a, t, k, _) in groups:
                i = times.index(t)
                masks[i, a, k] = states[i][:, a] == k
            part = _payoff_sum(groups, times, lambda i: by_point[i], lambda t: torch.exp(-r * t),
                               masks)
            grad += torch.autograd.grad(part, theta)[0]
            ties += _ties(groups, times, states, sums, masks, spots, vols, rate, n, start)
            blocks.append(states)
    if not differentiate:
        return pv / n, None
    jac = (grad / n).cpu().numpy()
    if ties:
        rebuilt = program_rebuild([torch.cat(s) for s in zip(*blocks)], spots, vols, rate, corr,
                                  times)
        for i, a, k, path, calls, puts, u in ties:
            jac += calls * u if bool(rebuilt[i][path, a] >= k) else -puts * u
    return pv / n, jac


def _ties(groups, times, states, sums, masks, spots, vols, rate, n, first_path):
    """The tied (date, asset, strike, path) of a block of paths, each with
    the counts of calls and puts at the strike and u [P], the tied path's
    e^{-rT} dS_T / d theta / N: the calls add it, the puts take it away."""
    n_a, out = len(spots), []
    for (i, a, k), tie in masks.items():
        if not bool(tie.any()):
            continue
        t = times[i]
        calls, puts = groups.get((a, t, k, True), 0), groups.get((a, t, k, False), 0)
        df = np.exp(-rate * t) / n
        where = torch.nonzero(tie).flatten()
        for p, s, ws in zip(where.tolist(), states[i][where, a].to(F64).tolist(),
                            sums[i][where, a].tolist()):
            u = np.zeros(2 * n_a + 1)
            u[a], u[n_a + a], u[2 * n_a] = df * s / spots[a], df * s * (ws - vols[a] * t), df * s * t
            out.append((i, a, k, first_path + p, calls, puts, u))
    return out


def program_rebuild(states32, spots, vols, rate, corr, times):
    """The float64 S [N, A] at each date as the port's differentiated route
    rebuilds them from the float32 states ``states32`` (one substep a date,
    the whole run's paths at once, as the port takes them): per date the
    correlated shock log(S_k / S_{k-1}) - (r - s^2 / 2) dt of consecutive
    float32 states, z from a triangular solve against the Cholesky factor L
    of the one-step covariance, and S <- S exp((r - s^2 / 2) dt + L z) from
    the rebuilt S, every operation in the port's order."""
    dev = states32[0].device
    p = [torch.tensor(float(x), dtype=F64, device=dev) for x in list(spots) + list(vols) + [rate]]
    n_a, n = len(spots), states32[0].shape[0]
    vol = torch.stack(p[n_a:2 * n_a])
    sigma, r = vol[None, :], p[2 * n_a]
    corr_t = torch.as_tensor(np.asarray(corr, dtype=np.float64), dtype=F64, device=dev)
    prev = torch.stack(p[:n_a]).expand(n, n_a)
    rebuilt, out, t_prev = prev, [], 0.0
    for t, state in zip(times, states32):
        dt = float(t) - t_prev
        if dt > 0.0:
            cur = state.to(F64)
            shock = torch.log(cur / prev) - (r - 0.5 * sigma * sigma) * ((t_prev + dt) - t_prev)
            chol = torch.linalg.cholesky(torch.outer(vol, vol) * corr_t * dt)
            z = torch.linalg.solve_triangular(chol.mT, shock, upper=True, left=False)
            noise = z[..., 0, None] * chol[None, :, 0]
            for e in range(1, n_a):
                noise = noise + z[..., e, None] * chol[None, :, e]
            drift = (r - 0.5 * sigma * sigma) * ((t_prev + dt) - t_prev)
            rebuilt = rebuilt * torch.exp(drift + noise)
            prev = cur
        out.append(rebuilt)
        t_prev = float(t)
    return out


def check(cfg, traffic, runs, device) -> Dict[str, float]:
    """The compared numbers of the sampled runs against the reference."""
    differentiate = bool(traffic["differentiate"])
    assets = model_parts(cfg)[0]
    names = [f"spot[{a}]" for a in assets] + [f"volatility[{a}]" for a in assets] + ["rate"]
    pv_gap, jac_gap = 0.0, 0.0
    for run in runs:
        (pv,) = run.values
        ref_pv, ref_jac = reference_run(cfg, traffic, run.seed, device, differentiate)
        pv_gap = max(pv_gap, abs(pv - ref_pv) / abs(ref_pv))
        if differentiate:
            jac = np.asarray([run.jac[0][run.param_names.index(p)] for p in names])
            scale = np.maximum(np.abs(ref_jac), np.median(np.abs(ref_jac)))
            jac_gap = max(jac_gap, float(np.max(np.abs(jac - ref_jac) / scale)))
    out = {"pv_gap": pv_gap}
    if differentiate:
        out["jac_gap"] = jac_gap
    return out
