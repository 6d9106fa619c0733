"""Plain reference of the Heston QE calibration surface: PV and jacobian.

The book: European calls on one Heston model with a constant rate, each
call its own netting set and quote; a quote's PV is the mean over paths of
its deflated payoff max(S_T - K, 0) / exp(r T) (the numeraire is the bank
account e^{r t}).

Departures from the published QE scheme (Andersen, "Efficient simulation
of the Heston stochastic volatility model", 2008), as the configuration
runs it:
  * the log-spot step takes gamma1 = 1, gamma2 = 0 (eq. 33: K0 = -rho
    kappa theta dt / sigma, K1 = (kappa rho / sigma - 1/2) dt - rho /
    sigma, K2 = rho / sigma, K3 = (1 - rho^2) dt, K4 = 0);
  * no eq.-44 martingale correction;
  * the branch switch at psi_c = 1.5;
  * guards of 1e-12 (``EPS``) on the divisions, the log and the square
    root, and p clipped below 1 - 1e-6, where the algebra below puts them;
  * the differentiated cell's fuzzy branches: the mass at zero of the
    exponential branch a linear ramp of width 0.3 in u - p, and the switch
    a ramp of width 0.5 in psi - 1.5 (each clamp((x + w) / (2 w), 0, 1)).

Paths (the forward cell): the configuration states float32 paths with hard
branches.  Per substep k of point i (counter i * num_steps + k) the draws
are Philox4x32-10 keyed (seed, 43) at counter (path, counter, 0, 0) (the
frozen stream of ``philox.py``): words 0 and 1 give the Box-Muller pair
(z_s, z_v), word 2 the uniform u.  The QE update is the path kernel's
algebra, every operation rounded to float32 in this order (read from
the port's ``csrc/heston_qe_step.cuh``, ``qe_scalars`` and ``qe_update``,
and from its plain twin ``heston_qe_substep`` in the port's
``ops/heston_qe.py``; nothing of them is imported): the scalars of (params,
dt) once per point, dt = (t_i - t_{i-1}) / num_steps rounded to float32;
then psi = s2 / m2 with m2 = m^2 + EPS, inv_psi = m2 / (s2 + EPS), b^2 =
max(tail + sqrt(2 inv_psi tail), 0) with tail = max(2 inv_psi - 1, 0), and
log S += drift + K1 v + K2 v' + sqrt(max(K3 v, EPS)) z_s.  The valuation
is float64.

Jacobian (the differentiated cell): the port values and differentiates a
float64 rebuild of the fuzzy QE recurrence on the kernel's emitted float32
draws, so the reference rebuilds the paths in float64 from its own draws
(the same stream, at the 40 substep-dense points) with the fuzzy step in
the algebra of the port's model step (``step_qe`` in the port's
``models/heston.py``, read, not imported): m and s^2 the CIR
conditional moments, psi = s2 / (m^2 + EPS), inv_psi = 1 / (psi + EPS),
b^2 = max(2 inv_psi - 1 + sqrt(2 inv_psi) sqrt(tail), 0), beta = (1 - p) /
(m + EPS).  The dense points are t_{i-1} + (t_i - t_{i-1}) k / num_steps
and the last one t_i, each step's dt the difference of its two ends.  The
jacobian by the 7 parameters is forward mode (``torch.func.jvp`` under
``vmap``) through that rebuild, in blocks of paths.  With the fuzzy ramps
the variance step is continuous in the parameters; the payoff's kink is
met with probability zero in float64.

Compared numbers (each the worst over the sampled runs):
  * ``pv_gap``: max over quotes of |PV - PV_ref| / |PV_ref| (0 where the
    two are equal, a quote no path reached included);
  * ``jac_gap``: max over quotes and parameters of |g - g_ref| over the
    larger of |g_ref| and the median |g_ref| over the quote's parameters.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from riskbench import book, counting
from riskbench.reference import philox

# A float32 product in TF32 would round differently; nothing here should.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK_PATHS = 1 << 18
F32, F64 = torch.float32, torch.float64
EPS = 1e-12
P_CLIP = 1.0 - 1e-6
PSI_C = 1.5
MASS_WIDTH, SWITCH_WIDTH = 0.3, 0.5
PARAMS = ("spot", "volatility", "rate", "rho", "kappa", "theta", "initial_variance")


def model_params(cfg) -> List[float]:
    """(spot, vol-of-vol, rate, rho, kappa, theta, v0), the port's order."""
    m = cfg["model"]
    return [float(m[k]) for k in ("spot", "sigma", "rate", "rho", "kappa", "theta", "v0")]


def quotes(cfg) -> List[List[Tuple[float, float, bool]]]:
    """Per netting set, its options as (maturity, strike, is call)."""
    return [[(float(p["exercise_date"]), float(p["strike"]), p["option_type"]["value"] == "CALL")
             for p in ns] for ns in book.netting_set_products(cfg)]


def timeline(cfg) -> List[float]:
    return sorted({t for ns in quotes(cfg) for t, _, _ in ns})


def path_launches(cfg, traffic) -> List[counting.Launch]:
    """K2's launches of one run: none (the paths are K1's)."""
    return []


def draws(seed: int, counter: int, paths: torch.Tensor):
    """(z_s, z_v, u) float32 of one substep for the given global paths."""
    dev = paths.device
    word = lambda v: torch.full((), int(v) & 0xFFFFFFFF, dtype=torch.int64, device=dev)
    w = philox.philox((paths, word(counter), word(0), word(0)), (seed, philox.PHASE_MAINSIM))
    r = torch.sqrt(-2.0 * torch.log(philox.uniform(w[0], F32)))
    angle = philox.uniform(w[1], F32) * philox.TWO_PI
    return r * torch.cos(angle), r * torch.sin(angle), philox.uniform(w[2], F32)


def kernel_substep(log_s, v, z_s, z_v, u, dt: float, prm):
    """One hard-branch QE update in the path kernel's float32 algebra; ``prm``
    the seven parameters as 0-d float32 tensors."""
    _, sigma, rate, rho, kappa, theta, _ = prm
    ekt = torch.exp(-kappa * dt)
    one_m_ekt = 1.0 - ekt
    sig2 = sigma * sigma
    c_m = theta * one_m_ekt
    c1 = sig2 * ekt * one_m_ekt / kappa
    c2 = theta * sig2 * one_m_ekt * one_m_ekt / (2.0 * kappa)
    k0 = -rho * kappa * theta / sigma * dt
    k1 = (kappa * rho / sigma - 0.5) * dt - rho / sigma
    k2 = rho / sigma
    k3 = (1.0 - rho * rho) * dt
    drift = rate * dt + k0

    m = c_m + v * ekt
    s2 = v * c1 + c2
    m2 = m * m + EPS
    psi = s2 / m2
    inv_psi = m2 / (s2 + EPS)
    tail = torch.clamp(2.0 * inv_psi - 1.0, min=0.0)
    b2 = torch.clamp(tail + torch.sqrt(2.0 * inv_psi * tail), min=0.0)
    a = m / (1.0 + b2)
    sb2_z = torch.sqrt(b2) + z_v
    v_quad = a * (sb2_z * sb2_z)
    p = torch.clamp((psi - 1.0) / (psi + 1.0), 0.0, P_CLIP)
    one_m_p = 1.0 - p
    v_tail = (torch.log(torch.clamp(one_m_p, min=EPS) / torch.clamp(1.0 - u, min=EPS))
              * (m + EPS) / (one_m_p + EPS))
    v_exp = torch.where(u > p, v_tail, torch.zeros_like(v_tail))
    v_next = torch.where(psi > PSI_C, v_exp, v_quad)
    vol = torch.sqrt(torch.clamp(k3 * v, min=EPS))
    return (log_s + drift) + k1 * v + k2 * v_next + vol * z_s, v_next


def kernel_states(seed: int, paths: torch.Tensor, params: Sequence[float], times: Sequence[float],
                  num_steps: int) -> List[torch.Tensor]:
    """log S at each date, [T] x [n] float32, for the given global paths."""
    prm = [torch.tensor(x, dtype=F64, device=paths.device).to(F32) for x in params]
    log_s = torch.log(prm[0]).expand(len(paths))
    v = prm[6].expand(len(paths))
    out, t_prev = [], 0.0
    for i, t in enumerate(times):
        dt = (t - t_prev) / num_steps
        if dt > 0.0:
            for k in range(num_steps):
                z_s, z_v, u = draws(seed, i * num_steps + k, paths)
                log_s, v = kernel_substep(log_s, v, z_s, z_v, u, dt, prm)
        out.append(log_s)
        t_prev = t
    return out


def _ramp(x, width: float):
    return torch.clamp((x + width) / (2.0 * width), 0.0, 1.0)


def fuzzy_step(log_s, v, z_s, z_v, u, dt: float, theta):
    """One fuzzy QE step in float64 (the port's model-step algebra);
    ``theta`` the [7] parameter vector."""
    _, sigma, rate, rho, kappa, theta_v, _ = theta.unbind()
    ekt = torch.exp(-kappa * dt)
    m = theta_v + (v - theta_v) * ekt
    s2 = (v * sigma * sigma * ekt * (1.0 - ekt) / kappa
          + theta_v * sigma * sigma * (1.0 - ekt) ** 2 / (2.0 * kappa))
    psi = s2 / (m * m + EPS)
    inv_psi = 1.0 / (psi + EPS)
    tail = torch.clamp(2.0 * inv_psi - 1.0, min=0.0)
    b2 = torch.clamp(2.0 * inv_psi - 1.0 + torch.sqrt(2.0 * inv_psi) * torch.sqrt(tail), min=0.0)
    a = m / (1.0 + b2)
    v_quad = a * (torch.sqrt(b2) + z_v) ** 2
    p = torch.clamp((psi - 1.0) / (psi + 1.0), 0.0, P_CLIP)
    beta = (1.0 - p) / (m + EPS)
    v_tail = torch.log(torch.clamp(1.0 - p, min=EPS) / torch.clamp(1.0 - u, min=EPS)) / (beta + EPS)
    v_exp = _ramp(u - p, MASS_WIDTH) * v_tail
    w = _ramp(psi - PSI_C, SWITCH_WIDTH)
    v_next = (1.0 - w) * v_quad + w * v_exp
    k0 = -rho * kappa * theta_v / sigma * dt
    k1 = (kappa * rho / sigma - 0.5) * dt - rho / sigma
    k2 = rho / sigma
    k3 = (1.0 - rho * rho) * dt
    vol = torch.sqrt(torch.clamp(k3 * v, min=EPS))
    return log_s + rate * dt + k0 + k1 * v + k2 * v_next + vol * z_s, v_next


def dense_steps(times: Sequence[float], num_steps: int) -> List[Tuple[int, float, int]]:
    """Per substep of the dense timeline (counter, dt, date index); a date
    at zero distance from the one before has none."""
    out, t_prev = [], 0.0
    for i, t in enumerate(times):
        span = t - t_prev
        if span > 0.0:
            ends = [t_prev + span * k / num_steps for k in range(1, num_steps)] + [t]
            start = t_prev
            for end in ends:
                out.append((len(out), (start + (end - start)) - start, i))
                start = end
        t_prev = t
    return out


def _payoff_sums(groups, times, log_s_at, rate):
    """[V]: per netting set, the sum over its options and paths of the
    deflated payoff."""
    sums = []
    for ns in groups:
        total = 0.0
        for t, k, call in ns:
            s = torch.exp(log_s_at(times.index(t)))
            pay = torch.clamp(s - k, min=0.0) if call else torch.clamp(k - s, min=0.0)
            total = total + (pay / torch.exp(rate * t)).sum()
        sums.append(total)
    return torch.stack(sums)


def forward_pvs(cfg, traffic, seed: int, device) -> np.ndarray:
    """[V] PVs of one run on K1's float32 paths, float64 valuation."""
    params, times, groups = model_params(cfg), timeline(cfg), quotes(cfg)
    n, steps = int(traffic["num_paths"]), int(cfg["num_steps"])
    rate = torch.tensor(params[2], dtype=F64, device=device)
    total = torch.zeros(len(groups), dtype=F64, device=device)
    for start in range(0, n, BLOCK_PATHS):
        paths = torch.arange(start, min(n, start + BLOCK_PATHS), dtype=torch.int64, device=device)
        states = kernel_states(seed & 0xFFFFFFFF, paths, params, times, steps)
        total += _payoff_sums(groups, times, lambda i: states[i].to(F64), rate)
    return (total / n).cpu().numpy()


def greeks(cfg, traffic, seed: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """([V] PVs, [V, 7] jacobian) of one run's float64 rebuild on the
    emitted draws."""
    params, times, groups = model_params(cfg), timeline(cfg), quotes(cfg)
    n, steps = int(traffic["num_paths"]), int(cfg["num_steps"])
    theta = torch.tensor(params, dtype=F64, device=device)
    schedule = dense_steps(times, steps)
    values = torch.zeros(len(groups), dtype=F64, device=device)
    jac = torch.zeros(len(groups), len(params), dtype=F64, device=device)
    for start in range(0, n, BLOCK_PATHS):
        paths = torch.arange(start, min(n, start + BLOCK_PATHS), dtype=torch.int64, device=device)
        noise = [tuple(x.to(F64) for x in draws(seed & 0xFFFFFFFF, c, paths))
                 for c, _, _ in schedule]

        def sums(th):
            log_s = torch.log(th[0]).expand(len(paths))
            v = th[6].expand(len(paths))
            at = [log_s] * len(times)
            for (_, dt, i), (z_s, z_v, u) in zip(schedule, noise):
                log_s, v = fuzzy_step(log_s, v, z_s, z_v, u, dt, th)
                at[i] = log_s
            return _payoff_sums(groups, times, lambda i: at[i], th[2])

        def sweep(tangent):
            return torch.func.jvp(sums, (theta,), (tangent,))

        primal, tangents = torch.func.vmap(sweep)(torch.eye(len(params), dtype=F64, device=device))
        values += primal[0]
        jac += tangents.T
    return (values / n).cpu().numpy(), (jac / n).cpu().numpy()


def _worst(a, b, scale) -> float:
    """The largest |a - b| / scale, 0 where a and b are equal (a quote that
    no path reached included)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    diff = np.abs(a - b)
    return float(np.max(np.divide(diff, scale, out=np.zeros_like(diff), where=a != b)))


def check(cfg, traffic, runs, device) -> Dict[str, float]:
    """The compared numbers of the sampled runs against the reference."""
    differentiate = bool(traffic["differentiate"])
    pv_gap, jac_gap = 0.0, 0.0
    for run in runs:
        if differentiate:
            ref_pv, ref_jac = greeks(cfg, traffic, run.seed, device)
            jac = np.asarray(run.jac)[:, [run.param_names.index(p) for p in PARAMS]]
            scale = np.maximum(np.abs(ref_jac), np.median(np.abs(ref_jac), axis=1, keepdims=True))
            jac_gap = max(jac_gap, _worst(jac, ref_jac, scale))
        else:
            ref_pv = forward_pvs(cfg, traffic, run.seed, device)
        pv_gap = max(pv_gap, _worst(run.values, ref_pv, np.abs(ref_pv)))
    out = {"pv_gap": pv_gap}
    if differentiate:
        out["jac_gap"] = jac_gap
    return out
